"""henbun_tpu_torch.parallel on the CPU: mesh sizing, ShardedOptimizer,
ShardedBatchedOptimizer, the chain-sharded samplers, sharded streaming,
the row-sharded full-batch evidence and the twins of the JAX package's
sharded nan guard, save/restore, natural-gradient GPR and SVGP tests,
on two gloo ranks against the JAX package and against the one-process
port.

The two ranks are ``tests/test_torch_parallel_ranks.py`` processes that meet
through a FileStore under tmp_path; they run every case once (a module
fixture) and the tests read their results. Tolerances: the full-batch GPR
objectives rtol 1e-5 against the JAX package's ShardedOptimizer on its
8-device CPU mesh (the same weights and the same JAX draws, injected);
the port's sharded runs against the one-process port at rtol 1e-5 (a
mean of two ranks' float32 sums against one sum over the union), the
chain-sharded samplers at rtol 1e-6 (the cross-chain quantities are
computed from gathered per-chain values by the one-process arithmetic);
the row-sharded evidence (SparseGPC, SparseGPRobust at n = 200 and 201,
m = 12, test_torch_sparse_evidence.py's data; SparseGPMulticlass at
n = 200 and 201, K = 3, m = 12, test_torch_multiclass.py's three-class
data) at rtol 1e-5 and 1e-5 of each leaf against the one-process port,
1e-10 in float64, and at rtol 1e-4 against the JAX package's sharded
value. The twins of the JAX tests' SVGP families and collective
contracts read the port's collective counters (``parallel.sharding``,
``parallel.rows``, ``parallel.chains``: calls, bytes, shapes) where the
JAX tests read the compiled program; each states its tolerance. Without
a card, the mesh's default device type (the ``[cuda] device`` setting)
raises; the ranks and the tests name ``device_type="cpu"``.
"""
import contextlib
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import henbun_tpu as jhb
from henbun_tpu import models as jmodels
from henbun_tpu.parallel import make_mesh as jax_mesh
from henbun_tpu.parallel import ShardedOptimizer as JaxSharded
import henbun_tpu_torch as thb
from henbun_tpu_torch import parallel
from henbun_tpu_torch.inference import chees, hmc, nuts, smc
from henbun_tpu_torch.interop import params_from_jax

import test_torch_parallel_ranks as ranks
from test_torch_multiclass import _three_class
from test_torch_sparse_evidence import _cls, _ep_reference, _outlier_bed

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
N = 6           # GPR points (test_torch_gpr.py's size)
M = 4           # fleet models, two a rank
K = 3           # minibatch rows a rank
CHAINS = 8
PARTICLES = 16
SVGP_N = 128    # tests/test_parallel.py's SVGP twin: rows,
SVGP_ROWS = 8   # and minibatch rows a rank
FAMILY_N = 64   # rows of the SVGP family twins


def _u(key, path="q", n=N):
    k = jax.random.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
    return np.asarray(jax.random.normal(k, (n,), dtype=jnp.float32))


def _jax_gpr():
    """JAX's ShardedOptimizer on its 8-device mesh: 5 Adam steps of the
    full-batch GPR ELBO, with the draws its chunk takes."""
    X, Y = jmodels.make_sine_dataset(n=N, seed=0)
    jm = jmodels.GPR(seed=0, X=X, Y=Y)
    jopt = JaxSharded(jm, jmodels.GPR.ELBO_gaussian.__wrapped__, mesh=jax_mesh())
    jopt.compile(optax.adam(0.01))
    params = {k: v.numpy() for k, v in params_from_jax(jm.param_dict()).items()}
    # the chunk's step keys: split(fold_in(base, count + 1), steps)
    keys = jax.random.split(jax.random.fold_in(jm._base_key, jm._key_count + 1), ranks.STEPS)
    noise = np.stack([_u(k) for k in keys])
    count = jm._key_count
    jopt.optimize(maxiter=ranks.STEPS)
    assert jm._key_count == count + 1 and len(jopt.history[-1]) == ranks.STEPS
    return X, Y, params, noise, np.asarray(jopt.history[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    X, Y, params, noise, jax_hist = _jax_gpr()
    inputs = {"gpr_X": X, "gpr_Y": Y, "gpr_noise": noise}
    inputs.update({"gpr_p:" + k: v for k, v in params.items()})
    am_X, am_Y = thb.models.make_synthetic_regression(n=64, d_x=4, seed=0)
    local_n = (64 - 6) // WORLD  # the Indexer's 90% train split, per rank
    inputs.update(am_X=am_X, am_Y=am_Y,
                  am_pos=rng.integers(0, local_n, (WORLD, ranks.STEPS, K)),
                  am_noise=rng.standard_normal((ranks.STEPS, WORLD * K, 2)).astype(np.float32))
    am_fleet = [thb.models.make_synthetic_regression(n=16, d_x=4, seed=i) for i in range(M)]
    inputs.update(am_fleet_X=np.stack([f[0] for f in am_fleet]),
                  am_fleet_Y=np.stack([f[1] for f in am_fleet]))
    fleet = [thb.models.make_sine_dataset(n=N, seed=i) for i in range(M)]
    inputs.update(fleet_X=np.stack([f[0] for f in fleet]), fleet_Y=np.stack([f[1] for f in fleet]),
                  fleet_noise=rng.standard_normal((ranks.STEPS, M, N)).astype(np.float32))
    inputs.update(chains_init=rng.standard_normal((CHAINS, 3)).astype(np.float32),
                  particles=rng.standard_normal((PARTICLES, 3)).astype(np.float32))
    sx = rng.normal(size=(1000, 3)).astype(np.float32)
    sy = (sx @ np.array([1.0, -2.0, 0.5], np.float32))[:, None] + 0.05 * rng.normal(
        size=(1000, 1)).astype(np.float32)
    path = str(d / "rows.f32")
    n, row_floats, slices, _ = thb.io.write_dataset(path, sx, sy)
    inputs.update(stream_path=np.array(path), stream_n=n, stream_row_floats=row_floats,
                  stream_slices=np.asarray(slices))
    inputs.update(_evidence_inputs(), mean_data=_mean_data(),
                  state_path=np.array(str(d / "state.pt")))
    sv_X = np.sort(rng.uniform(0, 6, (SVGP_N, 1)).astype(np.float32), axis=0)
    svgp_local = (SVGP_N - SVGP_N // 10) // WORLD  # the Indexer's train split, per rank
    inputs.update(svgp_X=sv_X, svgp_Y=(np.sin(sv_X) + 0.3 * rng.normal(size=sv_X.shape)).astype(
        np.float32), svgp_pos=rng.integers(0, svgp_local, (WORLD, ranks.TWIN_STEPS, SVGP_ROWS)))
    inputs.update(_family_inputs(rng))
    np.savez(d / "inputs.npz", **inputs)
    thb.io.loader._lib()  # build the loader once, before the ranks load it
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    script = str(ROOT / "tests" / "test_torch_parallel_ranks.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = [torch.load(d / ("rank%d.pt" % r), weights_only=False) for r in range(WORLD)]
    return inputs, jax_hist, out


def _mean_data(n=64):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 2)) + np.array([1.0, -2.0])).astype(np.float32)


def _family_inputs(rng):
    """tests/test_parallel.py's SVGP families' data at FAMILY_N rows: the
    three-class labels floor(x) mod 3 and Poisson counts of
    exp(sin x + 1) on sorted U[0, 6] inputs, make_hetero_dataset and
    make_multioutput_dataset; each rank's minibatch rows."""
    X = np.sort(rng.uniform(0, 6, (FAMILY_N, 1)).astype(np.float32), axis=0)
    hX, hY, _ = thb.models.make_hetero_dataset(n=FAMILY_N, seed=0)
    mX, mY, _ = thb.models.make_multioutput_dataset(n=FAMILY_N, seed=0)
    local = (FAMILY_N - FAMILY_N // 10) // WORLD  # the Indexer's train split, per rank
    return dict(fam_X=X, fam_labels=(np.floor(X[:, 0]) % 3).astype(np.int32)[:, None],
                fam_counts=rng.poisson(np.exp(np.sin(X) + 1.0)).astype(np.float32),
                hetero_X=hX, hetero_Y=hY, mo_X=mX, mo_Y=mY,
                fam_pos=rng.integers(0, local, (WORLD, ranks.TWIN_STEPS, ranks.FAMILY_ROWS)))


EVIDENCE_DATA = {"gpc": _cls, "robust": lambda n, seed: _outlier_bed(n, seed=3),
                 "multiclass": _three_class}
EVIDENCE_MODELS = {"gpc": (jmodels.SparseGPC, thb.models.SparseGPC),
                   "robust": (jmodels.SparseGPRobust, thb.models.SparseGPRobust),
                   "multiclass": (jmodels.SparseGPMulticlass, thb.models.SparseGPMulticlass)}


def _evidence_inputs():
    """Each evidence case's data and the JAX package's weights (after
    ``initialize()``, frozen z included), as ``se_*`` arrays."""
    out = {}
    for family, n in {(f, n) for _, f, _, n in ranks.EVIDENCE} | {
            ("gpc", 400), ("robust", 201), ("multiclass", 400)}:
        X, Y = EVIDENCE_DATA[family](n, seed=0)
        jhb.set_seed(0)
        jm = EVIDENCE_MODELS[family][0](seed=0, X=X, Y=Y, num_inducing=ranks.M_IND,
                                        **ranks.FAMILY_KW[family])
        jm.initialize()
        out["se_%s_%d_X" % (family, n)], out["se_%s_%d_Y" % (family, n)] = X, Y
        out.update({"se_p:%s_%d:%s" % (family, n, k): v.numpy()
                    for k, v in params_from_jax(jm.param_dict()).items()})
    return out


@pytest.fixture(scope="module")
def jax_evidence(run):
    """The JAX package's ShardedOptimizer value of each evidence case at
    the same weights: on its 8-device CPU mesh, on 3 devices for 201 rows
    (GSPMD needs the rows to divide), the EP floor pinned to the port's."""
    inputs = run[0]
    out = {}
    for name, family, method, n in ranks.EVIDENCE:
        X, Y = inputs["se_%s_%d_X" % (family, n)], inputs["se_%s_%d_Y" % (family, n)]
        jhb.set_seed(0)
        jm = EVIDENCE_MODELS[family][0](seed=0, X=X, Y=Y, num_inducing=ranks.M_IND,
                                        **ranks.FAMILY_KW[family])
        jm.initialize()
        mesh = jax_mesh() if n % 8 == 0 else jax_mesh(devices=jax.devices()[:3])
        mp = pytest.MonkeyPatch()
        try:
            _ep_reference(mp, method)
            jopt = JaxSharded(jm, method, mesh=mesh).compile(optax.adam(0.05))
            out[name] = float(jopt.run())
        finally:
            mp.undo()
    return out


def _same_on_ranks(out, case, key):
    a, b = (o[case][key] for o in out)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_sizing_and_the_single_process_group():
    """Without a group, make_mesh starts a one-rank one (gloo here); a
    ShardedOptimizer on it is the single-device driver, bit for bit."""
    assert not torch.distributed.is_initialized()
    try:
        mesh = parallel.make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == (parallel.DATA_AXIS, parallel.CHAIN_AXIS)
        with pytest.raises(ValueError, match="does not cover"):
            parallel.make_mesh(n_data=2, n_chain=1, device_type="cpu")
        runs = []
        for sharded in (False, True):
            thb.set_seed(0)
            X, Y = thb.models.make_sine_dataset(n=N, seed=0)
            m = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
            opt = (parallel.ShardedOptimizer(m, "ELBO_gaussian") if sharded
                   else thb.Optimizer(m, thb.models.GPR.ELBO_gaussian.__wrapped__))
            opt.compile(learning_rate=0.01).optimize(maxiter=3)
            runs.append(opt.history[-1])
        np.testing.assert_array_equal(runs[0], runs[1])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_mesh_sizing_two_ranks(run):
    _, _, out = run
    for o in out:
        m = o["mesh_sizes"]
        assert m["default"] == (WORLD, 1) and m["chain"] == (1, WORLD)
        assert "does not cover" in m["uncovered"]


def test_fullbatch_gpr_matches_the_jax_sharded_optimizer(run):
    _, jax_hist, out = run
    for o in out:
        np.testing.assert_allclose(o["gpr_fullbatch"]["hist"], jax_hist, rtol=1e-5)
    _same_on_ranks(out, "gpr_fullbatch", "params")


def test_minibatch_rows_match_the_one_process_port(run):
    """Each rank's injected rows and noise; the one-process port takes
    their union (rank 0's rows, then rank 1's) and its noise."""
    inputs, _, out = run
    rows = np.concatenate([o["amortized"]["rows"] for o in out], axis=1)
    thb.set_seed(0)
    m = thb.models.AmortizedRegression(seed=0, X=inputs["am_X"], Y=inputs["am_Y"], d_z=2,
                                       hidden=8, device="cpu")
    opt = m.ELBO().compile(learning_rate=0.01)
    opt.row_source = lambda s: rows[s]
    opt.noise_source = lambda s: {"z": torch.tensor(inputs["am_noise"][s])}
    opt.optimize(maxiter=ranks.STEPS, minibatch_size=WORLD * K)
    for o in out:
        np.testing.assert_allclose(o["amortized"]["hist"], opt.history[-1], rtol=1e-5)
        for k, v in m.param_dict().items():
            np.testing.assert_allclose(o["amortized"]["params"][k], v.detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _amortized_one_process(inputs, rows, noise=None):
    """The one-process port on injected rows (and noise, where given)."""
    thb.set_seed(0)
    m = thb.models.AmortizedRegression(seed=0, X=inputs["am_X"], Y=inputs["am_Y"], d_z=2,
                                       hidden=8, device="cpu")
    opt = m.ELBO().compile(learning_rate=0.01)
    opt.row_source = lambda s: rows[s]
    if noise is not None:
        opt.noise_source = lambda s: {"z": noise[s]}
    opt.optimize(maxiter=ranks.STEPS, minibatch_size=rows.shape[1])
    return opt.history[-1], m


def _assert_matches(got, hist, m):
    np.testing.assert_allclose(got["hist"], hist, rtol=1e-5)
    for k, v in m.param_dict().items():
        np.testing.assert_allclose(got["params"][k], v.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_drawn_noise_matches_the_one_process_port(run):
    """Each rank's rows injected, the noise drawn: every rank draws the
    noise of all the rows from the shared generator and keeps its block,
    which is the one-process run's draw on the union of the rows."""
    inputs, _, out = run
    rows = np.concatenate([o["amortized"]["rows"] for o in out], axis=1)
    hist, m = _amortized_one_process(inputs, rows)
    for o in out:
        _assert_matches(o["amortized_noise_drawn"], hist, m)


@pytest.mark.parametrize("mode", ["random", "block"])
def test_drawn_rows_and_noise_replay_in_one_process(run, mode):
    """Rows and noise drawn on the ranks. Replayed from the generator's
    state: each step's table of the ranks' shard offsets (block starts in
    block mode), each rank keeping its row, then the noise of all the rows;
    the one-process port on the union of the rows with that noise."""
    inputs, _, out = run
    got = out[0]["amortized_drawn"][mode]
    train, k = got["train_index"], 2
    local_n = len(train) // WORLD
    g = torch.Generator()
    g.set_state(got["state"])
    rows, noise = [], []
    for _ in range(ranks.STEPS):
        if mode == "block":
            start = torch.randint(0, local_n - k + 1, (WORLD, 1), generator=g).numpy()
            off = start + np.arange(k)
        else:
            off = torch.randint(0, local_n, (WORLD, k), generator=g).numpy()
        rows.append(np.concatenate([train[r * local_n + off[r]] for r in range(WORLD)]))
        noise.append(torch.randn((WORLD * k, 2), generator=g))
    hist, m = _amortized_one_process(inputs, np.stack(rows), noise)
    for o in out:
        _assert_matches(o["amortized_drawn"][mode], hist, m)


def test_drawn_rows_keep_the_parameters_replicated(run):
    _, _, out = run
    for mode in ("random", "block"):
        for o in out:
            assert np.isfinite(o["amortized_drawn"][mode]["hist"]).all()
        a, b = (o["amortized_drawn"][mode]["params"] for o in out)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "divisible by the mesh data-axis" in out[0]["amortized_drawn"]["indivisible"]


def test_sharded_fleet_matches_the_batched_optimizer(run):
    inputs, _, out = run
    thb.set_seed(0)
    models = [thb.models.GPR(seed=i, X=inputs["fleet_X"][i], Y=inputs["fleet_Y"][i],
                             device="cpu") for i in range(M)]
    bo = thb.BatchedOptimizer(models, "ELBO_gaussian").compile(learning_rate=0.01)
    bo.noise_source = lambda s: {"q": torch.tensor(inputs["fleet_noise"][s])}
    bo.optimize(maxiter=ranks.STEPS)
    for o in out:
        assert o["fleet"]["local"] == M // WORLD
        assert "divide evenly" in o["fleet"]["uneven"]
        np.testing.assert_allclose(o["fleet"]["hist"], bo.history[-1], rtol=1e-6)
        for got, m in zip(o["fleet"]["params"], models):
            for k, v in m.param_dict().items():
                np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-6, atol=1e-7,
                                           err_msg=k)


def test_sharded_fleet_draws_the_unsharded_fleets_noise(run):
    """The noise drawn (and a minibatch fleet's rows): every rank draws the
    whole fleet's and keeps its block, so the sharded fleet equals the
    BatchedOptimizer drawing its own."""
    inputs, _, out = run
    thb.set_seed(0)
    gprs = [thb.models.GPR(seed=i, X=inputs["fleet_X"][i], Y=inputs["fleet_Y"][i],
                           device="cpu") for i in range(M)]
    bo = thb.BatchedOptimizer(gprs, "ELBO_gaussian").compile(learning_rate=0.01)
    bo.optimize(maxiter=ranks.STEPS)
    thb.set_seed(0)
    ams = [thb.models.AmortizedRegression(seed=i, X=inputs["am_fleet_X"][i],
                                          Y=inputs["am_fleet_Y"][i], d_z=2, hidden=8,
                                          device="cpu") for i in range(M)]
    ba = thb.BatchedOptimizer(ams, "ELBO").compile(learning_rate=0.01)
    ba.optimize(maxiter=ranks.STEPS, minibatch_size=4)
    for o in out:
        for name, opt, models in (("gpr", bo, gprs), ("amortized", ba, ams)):
            np.testing.assert_allclose(o["fleet_drawn"][name], opt.history[-1], rtol=1e-6,
                                       err_msg=name)
            for got, m in zip(o["fleet_drawn"][name + "_params"], models):
                for k, v in m.param_dict().items():
                    np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-6,
                                               atol=1e-7, err_msg=name + " " + k)


@pytest.mark.parametrize("name", ["hmc", "chees", "nuts", "smc"])
def test_chain_sharded_sampler_matches_one_process(run, name):
    inputs, _, out = run
    if name == "smc":
        want = smc.sample(ranks.gauss_lp(), ranks.lik_lp(), torch.tensor(inputs["particles"]),
                          0, num_move_steps=2, num_leapfrog=3)
    else:
        mod = {"hmc": hmc, "chees": chees, "nuts": nuts}[name]
        kw = {"hmc": dict(num_leapfrog=4), "chees": {}, "nuts": dict(max_tree_depth=4)}[name]
        want = mod.sample(ranks.gauss_lp(), torch.tensor(inputs["chains_init"]), 0,
                          num_samples=10, num_warmup=25, **kw)
    for o in out:
        got = o["samplers"][name]
        for k, v in want._asdict().items():
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_streaming_into_a_sharded_optimizer(run):
    """tests/test_io.py's sharded streaming case: C++-prefetched
    megabatches swapped into a ShardedOptimizer recover the coefficients."""
    _, _, out = run
    for o in out:
        assert o["streaming"]["train_size"] == 512
        np.testing.assert_allclose(o["streaming"]["w"], [1.0, -2.0, 0.5], atol=0.1)
    np.testing.assert_array_equal(out[0]["streaming"]["w"], out[1]["streaming"]["w"])


# ------------------------------------------------- row-sharded full-batch evidence
def _leaves_close(got, want, what, tol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol * max(np.abs(v).max(), 1e-6),
                                   err_msg="%s %s" % (what, k))


def _one_process_evidence(inputs, family, n, method):
    """The one-process port: its zero-learning-rate step (in float32 and
    in float64), then 5 Adam steps, as the ranks take them."""
    got = ranks.evidence_step(getattr(ranks.evidence_model(inputs, family, n), method)())
    with ranks.float64():
        got["float64"] = ranks.evidence_step(
            getattr(ranks.evidence_model(inputs, family, n), method)())
    m = ranks.evidence_model(inputs, family, n)
    opt = getattr(m, method)().compile(learning_rate=0.05)
    opt.optimize(maxiter=ranks.STEPS)
    got.update(hist=opt.history[-1], params=ranks.params_of(m),
               ep_delta=[r.get("ep_delta") for r in opt.metrics.rows])
    return got


@pytest.mark.parametrize("case", ranks.EVIDENCE, ids=[c[0] for c in ranks.EVIDENCE])
def test_row_sharded_evidence_matches_the_one_process_port(run, case):
    """SparseGPC's Laplace and EP evidence and SparseGPRobust's Laplace
    evidence under ShardedOptimizer(minibatch_size=None) on two ranks:
    each rank holds one contiguous block of the rows (201 rows: 101 and
    100), and the objective, every gradient leaf and 5 Adam steps equal
    the one-process port's (rtol 1e-5; leaves within 1e-5 of their
    largest entry), on both ranks alike. In float64 the objective and the
    gradient agree to 1e-10: the split sums are exact. Where float32's
    reduction order cannot hold a leaf to 1e-5 (measured: the 201-row
    lengthscale gradient, 1.2e-5 apart, the one-process float32 itself
    1.1e-5 from float64), both float32 leaves are held to the float64 one
    at 1e-4."""
    inputs, _, out = run
    name, family, method, n = case
    want = _one_process_evidence(inputs, family, n, method)
    blocks = [tuple(o["sparse_evidence"][name]["block"]) for o in out]
    assert blocks == [(0, (n + 1) // 2), ((n + 1) // 2, n)]
    w64 = want["float64"]
    for o in out:
        got = o["sparse_evidence"][name]
        assert got["stats"]["calls"] > 0
        np.testing.assert_allclose(got["float64"]["value"], w64["value"], rtol=1e-10)
        _leaves_close(got["float64"]["grads"], w64["grads"], name + " float64 gradient", 1e-10)
        np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5, err_msg=name)
        for k, v in want["grads"].items():
            scale = max(np.abs(v).max(), 1e-6)
            if np.abs(got["grads"][k] - v).max() <= 1e-5 * scale:
                continue
            _leaves_close({k: got["grads"][k]}, {k: w64["grads"][k]}, name + " sharded/f64", 1e-4)
            _leaves_close({k: v}, {k: w64["grads"][k]}, name + " one process/f64", 1e-4)
        np.testing.assert_allclose(got["hist"], want["hist"], rtol=1e-5, err_msg=name)
        _leaves_close(got["params"], want["params"], name + " after 5 steps")
    a, b = (o["sparse_evidence"][name]["params"] for o in out)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if method.endswith("_ep"):
        # converged: the last sweep's mean site change is float32 noise on
        # either side, well under the guard's 1e-2
        for o in out:
            assert max(o["sparse_evidence"][name]["ep_delta"]) < 1e-4
        assert max(want["ep_delta"]) < 1e-4


@pytest.mark.parametrize("case", ranks.EVIDENCE, ids=[c[0] for c in ranks.EVIDENCE])
def test_row_sharded_evidence_matches_the_jax_sharded_optimizer(run, jax_evidence, case):
    _, _, out = run
    for o in out:
        np.testing.assert_allclose(o["sparse_evidence"][case[0]]["value"], jax_evidence[case[0]],
                                   rtol=1e-4, err_msg=case[0])


def test_row_sharded_ep_delta_is_the_one_process_mean(run):
    """After 3 sweeps the mean site change is large: each rank reports the
    mean over all rows, the one-process value (rtol 1e-4), so ShardedOptimizer's
    max over ranks changes nothing."""
    inputs, _, out = run
    want = ranks.evidence_step(ranks.evidence_model(inputs, "gpc", 200, ranks.FewSweeps).ep_few())
    assert want["metrics"]["ep_delta"] > 1e-3
    for o in out:
        got = o["evidence_collectives"]["ep_few"]
        np.testing.assert_allclose(got["metrics"]["ep_delta"], want["metrics"]["ep_delta"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5)
    a, b = (o["evidence_collectives"]["ep_few"]["metrics"]["ep_delta"] for o in out)
    assert a == b


def test_row_sharded_unrolled_ep_gradient_is_exact(run):
    """SparseGPRobust.log_marginal_ep differentiates through its 60
    unrolled sweeps; each sweep's all-reduce carries its gradient back
    (its backward all-reduces too): in float64, two ranks (101 and 100
    rows) give the one-process objective and gradient to 1e-10."""
    inputs, _, out = run
    with ranks.float64():
        want = ranks.evidence_step(ranks.evidence_model(inputs, "robust", 201).log_marginal_ep())
    for o in out:
        got = o["evidence_collectives"]["robust_ep"]
        assert got["stats"]["calls"] > 60
        np.testing.assert_allclose(got["value"], want["value"], rtol=1e-10)
        _leaves_close(got["grads"], want["grads"], "unrolled EP float64 gradient", 1e-10)


def test_row_sum_collectives_do_not_grow_with_the_rows(run):
    """The twin of test_parallel.py's collective contract: a sparse-Laplace
    step's all-reduces of row sums (forward and backward) are the same in
    number and bytes at 200 and at 400 rows, each at most m^2 + m + 5
    floats (the Newton system, its gradient and the ladder's psis)."""
    _, _, out = run
    for o in out:
        got = o["evidence_collectives"]
        assert got[200] == got[400] and got[200]["calls"] > 0
        assert got[200]["bytes"] <= 4 * (ranks.M_IND ** 2 + ranks.M_IND + 5) * got[200]["calls"]


def test_full_batch_objective_not_opted_in_runs_whole(run):
    inputs, _, out = run
    thb.set_seed(0)
    m = ranks.MeanModel(seed=0, data=inputs["mean_data"], device="cpu")
    opt = m.obj().compile(learning_rate=0.05)
    opt.optimize(maxiter=ranks.STEPS)
    for o in out:
        got = o["evidence_collectives"]["not_opted_in"]
        assert got["block"] is None and got["stats"] == {"calls": 0, "bytes": 0}
        np.testing.assert_allclose(got["hist"], opt.history[-1], rtol=1e-6)


# ------------------------- the twins of tests/test_parallel.py's optimizer tests
# The JAX tests run 300-600 steps at n = 2048 on 8 devices; these run 10-20
# steps at tens of rows, which is what tier-1's clock affords.
def test_sharded_nan_guard_rollback(run):
    """A step that is non-finite twice raises on every rank and leaves the
    parameters at the last good (here: the initial) values."""
    _, _, out = run
    for o in out:
        got = o["nan_guard"]
        assert "non-finite" in got["raised"]
        for k, v in got["before"].items():
            assert np.isfinite(v).all()
            np.testing.assert_array_equal(got["after"][k], v, err_msg=k)


def test_sharded_save_restore_bitwise(run):
    """save_state mid-run (rank 0 writes), continue, against a fresh
    ShardedOptimizer restoring that file and continuing: bitwise equal."""
    _, _, out = run
    for o in out:
        got = o["save_restore"]
        assert got["step"] == ranks.TWIN_STEPS // 2
        for k, v in got["continued"].items():
            np.testing.assert_array_equal(got["restored"][k], v, err_msg=k)
    _same_on_ranks(out, "save_restore", "continued")


def test_sharded_natgrad_gpr(run):
    """natural_gradient under the sharded full-batch step (not opted in:
    whole on every rank) equals the one-process port drawing the same
    noise from the same seed."""
    _, _, out = run
    from henbun_tpu_torch import optimizers

    thb.set_seed(0)
    X, Y = thb.models.make_sine_dataset(n=24)
    m = thb.models.GPR(seed=0, X=X, Y=Y, q_shape="fullrank", device="cpu")
    m.q.analytic_kl = True
    opt = m.ELBO_gaussian().compile(optimizers.natural_gradient(m, gamma=0.01,
                                                                rest=thb.adam(0.02)))
    opt.optimize(maxiter=ranks.TWIN_STEPS)
    for o in out:
        _assert_matches(o["natgrad_gpr"], opt.history[-1], m)


def test_sharded_svgp(run):
    """SVGPRegression.ELBO on minibatch rows: each rank's rows injected,
    the noise drawn, against the one-process port on the union of the
    rows drawing its own."""
    inputs, _, out = run
    union = np.concatenate([o["svgp"]["rows"] for o in out], axis=1)
    thb.set_seed(0)
    m = thb.models.SVGPRegression(seed=0, X=inputs["svgp_X"], Y=inputs["svgp_Y"],
                                  num_inducing=8, device="cpu")
    opt = m.ELBO().compile(learning_rate=0.01)
    opt.row_source = lambda s: union[s]
    opt.optimize(maxiter=ranks.TWIN_STEPS, minibatch_size=union.shape[1])
    for o in out:
        _assert_matches(o["svgp"], opt.history[-1], m)


# ------------------------------------------------------ the multiclass row sums
def test_row_sharded_multiclass_collectives_and_cholesky_flags(run):
    """SparseGPMulticlass's row sums (the softmax terms, A^T G, the two
    CholQR2 Grams, the trial psis, the IFT's w, the logdet's lambda): the
    same all-reduces in number and bytes at 200 and at 400 rows, each at
    most p^2 + p + 5 floats (p = K m, the Gram); and every factorization
    safe_cholesky's ladder reads back has the same NaN flag on both ranks
    and in one process, so every rank takes the same host decisions."""
    inputs, _, out = run
    p = ranks.CLASSES * ranks.M_IND
    with ranks.cholesky_flags() as flags:
        ranks.evidence_step(ranks.evidence_model(inputs, "multiclass", 200).log_marginal_laplace())
    assert flags
    for o in out:
        at200, at400 = (o["evidence_collectives"]["multiclass", n] for n in (200, 400))
        assert at200["stats"] == at400["stats"] and at200["stats"]["calls"] > 0
        assert at200["stats"]["bytes"] <= 4 * (p * p + p + 5) * at200["stats"]["calls"]
        assert at200["flags"] == flags
    a, b = (o["evidence_collectives"]["multiclass", 400]["flags"] for o in out)
    assert a == b


# ---------------- the twins of tests/test_parallel.py's families and collectives
def _family_twin(run, family):
    """The family's minibatch objective on the two ranks against the
    one-process port on the union of their rows drawing its own noise:
    in float64 the objectives and the parameters after 20 steps agree to
    rtol 1e-10 (the sharded step is the one-process step); in float32 the
    objectives to rtol 1e-5 and the parameters within 1e-4 of each leaf's
    largest entry (the float32 rounding of a near-zero gradient component,
    a mean of two ranks' sums against one sum, becomes a difference of
    Adam's normalised step: measured up to 2.4e-5 of a leaf at lr 0.02,
    the JAX tests' rate). And the steps' collectives: one all-reduce a step
    of the gradients and the objective (parameters + 1 floats), no row
    sum, no chain collective, nothing shaped like the batch."""
    inputs, _, out = run
    method = dict(ranks.SVGP_FAMILIES)[family]
    union = np.concatenate([o["svgp_families"][family]["rows"] for o in out], axis=1)
    want = []
    for dtype in ("float32", "float64"):
        with ranks.float64() if dtype == "float64" else contextlib.nullcontext():
            m = ranks.family_model(inputs, family)
            opt = getattr(m, method)().compile(learning_rate=0.02)
            opt.row_source = lambda s: union[s]
            opt.optimize(maxiter=ranks.TWIN_STEPS, minibatch_size=union.shape[1])
        assert np.isfinite(opt.history[-1]).all()
        want.append((opt.history[-1], ranks.params_of(m)))
    (h32, p32), (h64, p64) = want
    for o in out:
        got = o["svgp_families"][family]
        np.testing.assert_allclose(got["hist"], h32, rtol=1e-5)
        _leaves_close(got["params"], p32, family + " float32", 1e-4)
        np.testing.assert_allclose(got["float64"]["hist"], h64, rtol=1e-10)
        for k, v in p64.items():
            np.testing.assert_allclose(got["float64"]["params"][k], v, rtol=1e-10, atol=1e-12,
                                       err_msg=family + " float64 " + k)
        st = got["stats"]
        assert st["sharding"] == {"calls": ranks.TWIN_STEPS,
                                  "bytes": ranks.TWIN_STEPS * 4 * (got["floats"] + 1)}
        assert st["rows"]["calls"] == 0 and st["chains"]["calls"] == 0


@pytest.mark.parametrize("family", ["multiclass", "count"])
def test_sharded_multiclass_and_count(run, family):
    """SVGPMulticlass.ELBO (three latent GPs, labels floor(x) mod 3) and
    SVGPCount.ELBO_analytic (Poisson counts) at 64 rows, m = 8,
    minibatch 16, 20 steps (the JAX test: 2,048 rows, m = 16, 400
    steps)."""
    _family_twin(run, family)


@pytest.mark.parametrize("family", ["hetero", "multioutput"])
def test_sharded_hetero_and_lmc_svgp(run, family):
    """HeteroSVGP.ELBO_analytic and MultiOutputSVGP.ELBO_analytic (Q = 2)
    at 64 rows, m = 8, minibatch 16, 20 steps (the JAX test: 4,096 rows,
    m = 16, 600 steps)."""
    _family_twin(run, family)


def test_sharded_chunk_collectives(run):
    """The twin of test_sharded_chunk_hlo_collectives: 10 minibatch steps
    of the _MeanModel at minibatch 64 (32 rows a rank) take one
    all-reduce a step of the gradient and the objective, 3 floats (12
    bytes; a rank's [32, 2] rows would be 256), and no other collective."""
    _, _, out = run
    for o in out:
        got = o["chunk_collectives"]
        assert got["floats"] == 2
        assert got["stats"]["sharding"] == {"calls": 10, "bytes": 10 * 4 * (got["floats"] + 1)}
        assert got["stats"]["rows"] == {"calls": 0, "bytes": 0}
        assert got["stats"]["chains"]["calls"] == 0


def test_smc_resampling_collectives(run):
    """The twin of test_smc_resampling_hlo_collectives: an SMC stage over
    the chain-sharded particles gathers the [P] log-likelihoods, the one
    [P, dim] particle block the resampled block is taken from and the [P]
    accept counts, P (dim + 2) floats a stage whatever the number of
    moves (2 and 4); the run's one other collective is the final [P, dim]
    gather of the particles."""
    _, _, out = run
    P, dim = PARTICLES, 3
    per_stage = set()
    for o in out:
        for moves, got in o["smc_collectives"].items():
            st, k = got["stats"]["chains"], got["stages"]
            assert k > 0
            assert st["shapes"] == {(P, dim): k + 1, (P, 1): 2 * k}, (moves, st)
            assert st["calls"] == 3 * k + 1
            per_stage.add((st["bytes"] - 4 * P * dim) / k)
    assert per_stage == {4 * P * (dim + 2)}


# ------------------------------------------- no silent CPU default (no card here)
def test_make_mesh_without_a_card_raises_unless_told_cpu(tmp_path):
    """With no card, make_mesh() and a two-rank initialize_distributed()
    take the [cuda] device setting's CUDA and raise, as a Model does, and
    start no group; told "cpu" (or with the setting at cpu) they build a
    gloo CPU mesh."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is there to take")
    assert not dist.is_initialized()
    for call in (parallel.make_mesh, lambda: parallel.make_mesh(device_type="cuda"),
                 lambda: parallel.initialize_distributed(
                     "file://" + str(tmp_path / "store"), world_size=2, rank=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert not dist.is_initialized()
    cfg = thb.settings.get_settings()
    cfg.cuda.device = "cpu"
    try:
        with thb.settings.temp_settings(cfg):
            mesh = parallel.make_mesh()
        assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
