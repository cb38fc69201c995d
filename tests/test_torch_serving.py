"""henbun_tpu_torch.serving on the CPU: the twin of tests/test_serving.py.

Contract: an exported artifact (1) equals the in-process model call,
(2) is self-contained: callable from its bytes alone, in a process that
never imports the model families, (3) optionally serves any request size
from one program. The fitted state is the JAX package's, carried over by
``interop.params_from_jax``, and the port's artifact is held against the
JAX package's ``export_predictor`` artifact on the same inputs: rtol 1e-4,
atol 1e-5 (float32 factorizations and solves in another order), and the
JAX tests' rtol 1e-3 for the SVGP and sparse-Laplace polymorphic cases.
Against the port's own eager call: rtol 1e-5, atol 1e-6 (the JAX tests'
bound; the same arithmetic, traced). Fits are short: the point is the
export, not the fit.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

import henbun_tpu as jhb
from henbun_tpu import serving as jserving
from henbun_tpu import models as jmodels
import henbun_tpu_torch as thb
from henbun_tpu_torch import serving
from henbun_tpu_torch.interop import params_from_jax
from henbun_tpu_torch.ops import cuda_chol, linalg

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ("cpu",)


def _port(jm, tcls, **kw):
    tm = tcls(device="cpu", **kw)
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return tm


def _grid(n, lo=0.0, hi=6.0):
    return np.linspace(lo, hi, n).reshape(-1, 1).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def fitted_marginal():
    jhb.set_seed(0)
    X, Y = jmodels.make_sine_dataset(n=30)
    jm = jmodels.GPRMarginal(X=X, Y=Y)
    jm.log_marginal().compile(optax.adam(0.05)).optimize(maxiter=50)
    return jm, _port(jm, thb.models.GPRMarginal, X=X, Y=Y)


def test_predictor_roundtrip_matches_model(fitted_marginal, tmp_path):
    jm, tm = fitted_marginal
    grid = _grid(50, -1.0, 7.0)
    eager = tm.run(lambda mm: mm.predict_f(grid))
    art = serving.export_predictor(tm, thb.models.GPRMarginal.predict_f, grid, platforms=CPU)
    got = art(torch.tensor(grid))
    _close(got, eager)
    jart = jserving.export_predictor(jm, jmodels.GPRMarginal.predict_f, grid, platforms=CPU)
    _close(got, jart(jnp.asarray(grid)), rtol=1e-4, atol=1e-5)

    # disk roundtrip: file -> fresh artifact, same numbers
    p = tmp_path / "gpr_predictor.pt2z"
    art.save(p)
    art2 = serving.load(p)
    for a, b in zip(art2(torch.tensor(grid)), got):
        assert torch.equal(a, b)
    assert art2.platforms == ("cpu",)
    assert art2.in_avals == art2.in_specs and art2.in_specs[0].shape == (50, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.export_predictor(tm, "predict_f", grid)


def test_artifact_is_self_contained(fitted_marginal, tmp_path):
    _, tm = fitted_marginal
    grid = _grid(20)
    blob = serving.export_predictor(tm, "predict_f", grid, platforms=CPU).serialize()
    assert isinstance(blob, bytes) and len(blob) > 0
    art = serving.deserialize(blob)
    mean, var = art(grid)  # numpy in, no CUDA program: the CPU's
    assert mean.device.type == "cpu"
    assert mean.shape == (20, 1) and var.shape == (20, 1)
    assert torch.isfinite(mean).all() and (var >= 0).all()

    # a fresh process that imports torch and serving only, never the models
    path = tmp_path / "art.pt2z"
    path.write_bytes(blob)
    code = (
        "import sys, numpy as np, torch\n"
        "from henbun_tpu_torch import serving\n"
        "art = serving.load(sys.argv[1])\n"
        "mean, var = art(torch.tensor(np.linspace(0, 6, 20, dtype=np.float32)[:, None]))\n"
        "assert 'henbun_tpu_torch.models' not in sys.modules\n"
        "np.save(sys.argv[2], torch.cat([mean, var], 1).numpy())\n"
    )
    out = tmp_path / "served.npy"
    res = subprocess.run([sys.executable, "-c", code, str(path), str(out)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    np.testing.assert_array_equal(np.load(out), torch.cat([mean, var], 1).numpy())


def test_numpy_requests_run_on_the_card_by_default(monkeypatch):
    """Numpy arguments and a scalar seed pick the CUDA program when torch
    finds a card; an array tensor's device picks its own program."""
    both = serving.ServingArtifact({"cpu": b"", "cuda": b""})
    grid = _grid(4)
    seed = torch.tensor(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert both._platform((grid,)) == "cuda"
    assert both._platform((seed, grid)) == "cuda"
    assert both._platform((seed, torch.tensor(grid))) == "cpu"
    assert serving.ServingArtifact({"cpu": b""})._platform((grid,)) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert both._platform((grid,)) == "cpu"


def test_batch_polymorphic_serves_any_size(fitted_marginal):
    """One program from 1 point to past K2's 128-column width."""
    jm, tm = fitted_marginal
    art = serving.export_predictor(tm, thb.models.GPRMarginal.predict_f, _grid(8),
                                   platforms=CPU, batch_polymorphic=True)
    jart = jserving.export_predictor(jm, jmodels.GPRMarginal.predict_f, _grid(8),
                                     platforms=CPU, batch_polymorphic=True)
    for n in (1, 3, 8, 57, 200):
        g = _grid(n)
        got = art(torch.tensor(g))
        assert got[0].shape == (n, 1)
        _close(got, tm.run(lambda mm: mm.predict_f(g)))
        _close(got, jart(jnp.asarray(g)), rtol=1e-4, atol=1e-5)


def test_batch_polymorphic_multiple_array_args(fitted_marginal):
    """Every array argument shares ONE symbolic batch dimension."""
    jm, tm = fitted_marginal

    def weighted_mean(mm, x_new, w):
        mean, _ = mm.predict_f(x_new)
        return mean * w

    w8 = np.full((8, 1), 2.0, np.float32)
    art = serving.export_predictor(tm, weighted_mean, _grid(8), w8, platforms=CPU,
                                   batch_polymorphic=True)
    jart = jserving.export_predictor(jm, weighted_mean, _grid(8), w8, platforms=CPU,
                                     batch_polymorphic=True)
    assert art.in_specs[0].shape[0] == art.in_specs[1].shape[0]
    for n in (5, 8, 21):
        g, w = _grid(n), np.full((n, 1), 2.0, np.float32)
        out = art(torch.tensor(g), torch.tensor(w))
        assert out.shape == (n, 1)
        ref = 2.0 * tm.run(lambda mm: mm.predict_f(g))[0]
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(jart(jnp.asarray(g), jnp.asarray(w))),
                                   rtol=1e-4, atol=1e-5)


def test_sampler_export_reproducible_draws():
    """Draws come from a counter-based stream keyed by the seed inside the
    program: the same seed gives the same draws bit for bit, another seed
    other draws, and they spread around the fitted posterior."""
    jhb.set_seed(1)
    X, Y = jmodels.make_sine_dataset(n=20)
    jm = jmodels.GPR(X=X, Y=Y, q_shape="diagonal")
    jm.ELBO_gaussian().compile(optax.adam(0.05)).optimize(maxiter=200)
    tm = _port(jm, thb.models.GPR, X=X, Y=Y, q_shape="diagonal")
    grid = _grid(15)
    art = serving.export_sampler(tm, thb.models.GPR.predict_f, 16, grid, platforms=CPU)
    s0 = art(np.uint32(7), torch.tensor(grid))
    s1 = art(7, torch.tensor(grid))
    s2 = art(torch.tensor(8), torch.tensor(grid))
    assert s0.shape == (16, 15, 1)
    assert torch.equal(s0, s1)
    assert (s0 - s2).abs().max() > 1e-6
    mean = s0.mean(0)[:, 0].numpy()
    assert np.abs(mean - np.sin(grid[:, 0])).max() < 1.0
    # the draws are the posterior's: their spread matches the port's own
    # Monte Carlo draws of the same function (independent streams)
    ref = tm.draws(lambda mm: mm.predict_f(grid), 256)
    np.testing.assert_allclose(art(3, torch.tensor(grid)).std(0).mean().item(),
                               ref.std(0).mean().item(), rtol=0.5)


def test_exported_constants_are_frozen(fitted_marginal):
    """Mutating the model after export does not change the artifact."""
    _, tm = fitted_marginal
    grid = _grid(10)
    art = serving.export_predictor(tm, "predict_f", grid, platforms=CPU)
    before = art(torch.tensor(grid))[0]
    old = np.asarray(tm.k_var.value)
    try:
        tm.k_var = old * 5.0
        live = tm.run(lambda mm: mm.predict_f(grid))[0]
        frozen = art(torch.tensor(grid))[0]
        assert torch.equal(before, frozen)
        assert (live - frozen).abs().max() > 0
    finally:
        tm.k_var = old


def test_export_svgp_marginal_predictor():
    """Inducing-point models export too: MinibatchData rows freeze into the
    artifact and the marginal predictor serves new inputs."""
    jhb.set_seed(11)
    rng = np.random.default_rng(11)
    X = np.sort(rng.uniform(0, 6, size=(512, 1))).astype(np.float32)
    Y = (np.sin(X) + rng.normal(size=X.shape) * 0.2).astype(np.float32)
    jm = jmodels.SVGPRegression(seed=11, X=X, Y=Y, num_inducing=16)
    jm.ELBO_analytic().compile(optax.adam(0.02)).optimize(maxiter=100, minibatch_size=128)
    tm = _port(jm, thb.models.SVGPRegression, X=X, Y=Y, num_inducing=16)
    grid = _grid(25, 0.3, 5.7)
    want = tm.run(lambda mm: mm.predict_f_marginals(grid))
    art = serving.export_predictor(tm, "predict_f_marginals", grid, platforms=CPU,
                                   batch_polymorphic=True)
    got = art(torch.tensor(grid))
    _close(got, want, rtol=1e-3, atol=1e-5)
    jart = jserving.export_predictor(jm, "predict_f_marginals", grid, platforms=CPU,
                                     batch_polymorphic=True)
    _close(got, jart(jnp.asarray(grid)), rtol=1e-3, atol=1e-5)
    mean2, _ = art(torch.tensor(_grid(7, 1.0, 5.0)))
    assert mean2.shape == (7, 1)


def test_export_sparse_laplace_classifier():
    """The sparse Laplace engine (Newton ladder and m x m algebra) traces
    into one program that serves p(y=1 | x*) at any batch size."""
    jhb.set_seed(3)
    rng = np.random.default_rng(3)
    X = np.sort(rng.uniform(0, 6, (2000, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Y = (rng.uniform(size=X.shape) < p_true).astype(np.float32)
    jm = jmodels.SparseGPC(seed=3, X=X, Y=Y, num_inducing=32)
    jm.log_marginal_laplace().compile(optax.adam(0.05)).optimize(maxiter=10)
    tm = _port(jm, thb.models.SparseGPC, X=X, Y=Y, num_inducing=32)
    grid = _grid(30, 0.2, 5.8)
    want = tm.run(lambda mm: mm.predict_p(grid))
    art = serving.export_predictor(tm, "predict_p", grid, platforms=CPU, batch_polymorphic=True)
    got = art(torch.tensor(grid))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
    jart = jserving.export_predictor(jm, "predict_p", grid, platforms=CPU,
                                     batch_polymorphic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jart(jnp.asarray(grid))), rtol=1e-3,
                               atol=1e-4)
    p2 = art(torch.tensor(_grid(11, 1.0, 5.0)))
    assert p2.shape == (11, 1) and ((p2 > 0) & (p2 < 1)).all()


def test_multioutput_predictor_reaches_both_custom_ops():
    """The exported path that reaches K1 and K2: MultiOutputGPR with
    per-latent kernels factors its [Q, n, n] grams in one batch and solves
    [Q, n, n*] against them, through the custom ops, at any n*."""
    jhb.set_seed(0)
    X, Y, _ = jmodels.make_multioutput_dataset(n=12, seed=0)
    jm = jmodels.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, shared_kernel=False)
    jm.ELBO_analytic().compile(optax.adam(0.02)).optimize(maxiter=20)
    tm = _port(jm, thb.models.MultiOutputGPR, X=X, Y=Y, Q=2, shared_kernel=False)
    art = serving.export_predictor(tm, "predict_f", _grid(8), platforms=CPU,
                                   batch_polymorphic=True)
    ops = {str(n.target) for n in art._program("cpu").graph.nodes if n.op == "call_function"}
    assert {"henbun_tpu_torch.cholesky128.default",
            "henbun_tpu_torch.tri_solve128.default"} <= ops
    jart = jserving.export_predictor(jm, "predict_f", _grid(8), platforms=CPU,
                                     batch_polymorphic=True)
    for n in (5, 100, 200):
        g = _grid(n, -0.5, 6.5)
        got = art(torch.tensor(g))
        _close(got, tm.run(lambda mm: mm.predict_f(g)))
        _close(got, jart(jnp.asarray(g)), rtol=1e-4, atol=1e-5)


def test_export_runs_the_masked_ladder():
    """Under torch.export, safe_cholesky escalates as a fixed masked ladder
    with no host read: on a batch whose matrix 1 fails at the first jitter
    and matrix 2 at the first and second, the ladder gives the eager
    loop's factor, and so does the exported program."""
    rng = np.random.default_rng(0)
    n = 6
    Q, _ = np.linalg.qr(rng.normal(size=(3, n, n)))
    eig = np.tile(np.linspace(0.5, 2.0, n), (3, 1))
    eig[1, 0], eig[2, 0] = -5e-5, -5e-3  # fixed by jitter x100 and x10^4
    A = torch.tensor(((Q * eig[:, None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32))
    jitter = 1e-6
    eager = linalg.safe_cholesky(A, jitter)
    assert torch.isfinite(eager).all()
    assert torch.isnan(cuda_chol.cholesky128_plain(A + jitter * torch.eye(n))).flatten(1).any(1)\
        .tolist() == [False, True, True]
    assert torch.isnan(cuda_chol.cholesky128_plain(A + 100 * jitter * torch.eye(n)))\
        .flatten(1).any(1).tolist() == [False, False, True]
    assert torch.equal(linalg.escalating_cholesky(A, jitter, read_host=False), eager)

    class Factor(torch.nn.Module):
        def forward(self, a):
            return linalg.safe_cholesky(a, jitter)

    ep = torch.export.export(Factor(), (A,))
    assert torch.equal(ep.module()(A), eager)
