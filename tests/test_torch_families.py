"""The port's remaining model families (ExpertGPR, heteroscedastic,
multi-output, deep GP, GP-LVM) against the JAX package on the CPU.

The same numpy-seeded data, the same weights (``interop.params_from_jax``
after the JAX model's ``initialize``), the same minibatch rows and the same
noise: each Variational node's ``u`` drawn from JAX's key for its path and
each tagged draw (``"<tag>#<n>"``) from JAX's tagged key, injected into the
port. Sizes: ExpertGPR n = 20, HeteroscedasticGPR n = 16, the sparse
families n = 64 with m = 8 and 16-row minibatches, MultiOutputGPR n = 12
(P = 3, Q = 2), DeepGP n = 48 (m = 8), GP-LVM n = 48 (m = 8).

Tolerances: objective values rtol 1e-4; predictions and each gradient
leaf within 1e-4 of their largest entry. Where a prediction or a leaf
misses that, the port's float64 evaluation at the same weights, rows and
noise arbitrates: both the port's float32 and the JAX package's float32
must lie within ``F64_TOL`` = 2e-3 of it (of the largest entry). These
exact-gram families factor RBF grams at a jitter of 1e-4 whose condition
numbers reach ~1e5, which float32 rounding in either package's kernel
matrix amplifies. Measured on these cases (about 40 comparisons need
the witness): the JAX package's float32 is up to 1.0e-3 of the largest entry
from float64 (a per-latent MultiOutputGPR lengthscale gradient), the
port's up to 1.7e-3 (the last layer's z gradient of the depth-3 DeepGP),
the two packages up to 2.2e-3 apart.
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import henbun_tpu as jhb
from henbun_tpu import models as jmodels
from henbun_tpu import optimizers as jopt_mod
from henbun_tpu.batched import BatchedOptimizer as JaxBatched
from henbun_tpu.models import hetero as jhetero
import henbun_tpu_torch as thb
from henbun_tpu_torch import models as tmodels
from henbun_tpu_torch import optimizers as topt_mod
from henbun_tpu_torch.interop import params_from_jax
from henbun_tpu_torch.models import hetero as thetero

ROWS = np.random.default_rng(3).choice(64, 16, replace=False)


def _node_u(key, path, shape):
    """The noise the JAX package draws for the node at `path`."""
    k = jax.random.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
    return torch.tensor(np.asarray(jax.random.normal(k, shape, dtype=jnp.float32)))


def _tagged_u(key, tag, shape, c=0):
    """The JAX package's c-th draw under a tag (context.tagged_key)."""
    k = jax.random.fold_in(key, zlib.crc32(tag.encode()) & 0x7FFFFFFF)
    return torch.tensor(np.asarray(
        jax.random.normal(jax.random.fold_in(k, c), shape, dtype=jnp.float32)))


def _global_noise(tmodel, key):
    """Injected noise for every non-LOCAL Variational node of a port model."""
    out = {}

    def walk(node):
        if isinstance(node, thb.variationals.Variational) and node.collections != "LOCAL":
            path = node.path_to(tmodel)
            out[path] = _node_u(key, path, tuple(node.n_layers) + (node.size,))
        for child in getattr(node, "sorted_variables", []):
            walk(child)

    walk(tmodel)
    return out


def _tagged(key, tag, shape, count):
    return {"%s#%d" % (tag, c): _tagged_u(key, tag, shape, c) for c in range(count)}


def _close(got, want, what, scale=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-6), err_msg=what)


F64_TOL = 2e-3


class Pair:
    """The JAX model and optimizer, the port's at JAX's weights, and what
    rebuilds the port's in float64 for the witness."""

    def __init__(self, jcls, tcls, method, lr=0.01, **kw):
        self.tcls, self.method, self.kw = tcls, method, kw
        self.jm = jcls(seed=0, **kw)
        self.jopt = getattr(self.jm, method)().compile(optax.adam(lr))
        self.tm, self.topt = self.port(torch.float32)
        assert sorted(self.tm.param_dict()) == sorted(self.jm.param_dict())

    def port(self, dtype):
        """(model, optimizer) of the port at the JAX model's weights."""
        tm = self.tcls(seed=0, device="cpu", **self.kw)
        tm.set_param_dict({k: v.to(dtype) for k, v in
                           params_from_jax(self.jm.param_dict()).items()})
        return tm, getattr(tm, self.method)().compile()

    def float64(self, fn):
        """fn(model, optimizer) evaluated on the port in float64."""
        cfg = thb.settings.get_settings()
        cfg.dtypes.float_type = torch.float64
        with thb.settings.temp_settings(cfg):
            return fn(*self.port(torch.float64))


def _double(noise):
    return None if noise is None else {k: v.double() for k, v in noise.items()}


def _held(got, want, witness, what):
    """got (port float32) within 1e-4 of want (JAX float32) of the largest
    entry, or both within F64_TOL of the port's float64 `witness()`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    if np.abs(got - want).max() <= 1e-4 * scale:
        return
    w64 = np.asarray(witness(), np.float64)
    scale = max(np.abs(w64).max(), 1e-6)
    dev_t, dev_j = np.abs(got - w64).max() / scale, np.abs(want - w64).max() / scale
    assert dev_t <= F64_TOL and dev_j <= F64_TOL, (what, dev_t, dev_j)


def _port_value_and_grads(topt, noise, rows=None):
    data = topt._data_args()
    if rows is not None:
        data = topt._take_rows(data, torch.as_tensor(rows))
    for t in topt._trainable.values():
        t.grad = None
    val, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, data,
                                     topt.model.generator, noise)
    val.backward()
    # a leaf the objective does not read has no .grad (JAX: zeros)
    return val.item(), {k: np.zeros(tuple(t.shape)) if t.grad is None
                        else t.grad.numpy() for k, t in topt._trainable.items()}


def _compare(pair, key, noise, rows=None):
    """Value and every gradient leaf against JAX (module docstring)."""
    jopt = pair.jopt
    idx = None if rows is None else jnp.asarray(rows)
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda t, f, d, i, k: jopt._evaluate(t, f, d, i, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), idx, key)
    val_t, g_t = _port_value_and_grads(pair.topt, noise, rows)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4)
    assert set(g_j) == set(g_t)
    g64 = []

    def witness(k):
        if not g64:
            g64.append(pair.float64(
                lambda tm, topt: _port_value_and_grads(topt, _double(noise), rows)[1]))
        return g64[0][k]

    for k, want in g_j.items():
        _held(g_t[k], want, lambda: witness(k), k)
    return g_j


def _predict(pair, fn, key, noise=None):
    want = pair.jm.run(fn, key=key)
    got = pair.tm.run(fn, noise=noise)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    out64 = []

    def witness(i):
        if not out64:
            res = pair.float64(lambda tm, topt: tm.run(fn, noise=_double(noise)))
            out64.append(res if isinstance(res, tuple) else (res,))
        return out64[0][i].numpy()

    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(np.shape(w))
        _held(g.numpy(), w, lambda: witness(i), "output %d" % i)


# ------------------------------------------------------------------ ExpertGPR
def _expert():
    X, Y = jmodels.make_expert_dataset(n=20, seed=0)
    tX, tY = tmodels.make_expert_dataset(n=20, seed=0)
    np.testing.assert_array_equal(X, tX)
    np.testing.assert_array_equal(Y, tY)
    return dict(X=X, Y=Y)


@pytest.mark.parametrize("method", ["ELBO", "ELBO_single"])
def test_expert_gpr_objectives_match_jax(method):
    pair = Pair(jmodels.ExpertGPR, tmodels.ExpertGPR, method, **_expert())
    key = jax.random.PRNGKey(3)
    noise = _global_noise(pair.tm, key)
    assert sorted(noise) == ["q_l", "q_r", "q_s"]
    _compare(pair, key, noise)


def test_expert_gpr_predict_f_matches_jax():
    pair = Pair(jmodels.ExpertGPR, tmodels.ExpertGPR, "ELBO", **_expert())
    x_new = np.linspace(-1.2, 1.2, 9, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(4)
    noise = _global_noise(pair.tm, key)
    noise.update(_tagged(key, "gp_cond_diag", (1, 9), 3))
    _predict(pair, lambda mm: mm.predict_f(x_new), key, noise)


# ---------------------------------------------------------- heteroscedastic
def _hetero(n=16, seed=0):
    X, Y, sd = jmodels.make_hetero_dataset(n=n, seed=seed)
    np.testing.assert_array_equal(Y, tmodels.make_hetero_dataset(n=n, seed=seed)[1])
    return X, Y


@pytest.mark.parametrize("q_shape", ["diagonal", "fullrank", "fullrank_packed"])
def test_whitened_q_marginals_match_jax(q_shape):
    X, Y = _hetero()
    pair = Pair(jmodels.HeteroscedasticGPR, tmodels.HeteroscedasticGPR, "ELBO_analytic",
                X=X, Y=Y, q_shape=q_shape)
    x_new = np.linspace(-0.5, 6.5, 7, dtype=np.float32)[:, None]

    def fn(mm):
        mod, conv = ((jhetero, jnp.asarray) if isinstance(mm, jhb.model.Model)
                     else (thetero, lambda x: torch.as_tensor(x, dtype=mm.X.dtype)))
        at_train = mod.whitened_q_marginals(mm.__dict__["q_g"], mm.kern_g.Cholesky(mm.X))
        at_new = mod.whitened_q_marginals_at(mm.__dict__["q_f"], mm.kern_f,
                                             mm.kern_f.Cholesky(mm.X), mm.X, conv(x_new))
        return at_train + at_new

    _predict(pair, fn, jax.random.PRNGKey(0))


def test_hetero_fullrank_init_is_near_identity():
    """The init cliff's cure: both fullrank factors start at I + 0.01
    free, and the analytic ELBO is finite at n = 120 from the start."""
    X, Y = _hetero(n=120)
    tm = tmodels.HeteroscedasticGPR(seed=0, X=X, Y=Y, device="cpu")
    for name in ("q_f", "q_g"):
        L = np.asarray(getattr(tm, name).q_sqrt.free_value)
        assert np.abs(np.diag(L) - 1.0).max() < 0.05
        assert np.abs(L - np.diag(np.diag(L))).max() < 0.05
    val = tm.run(lambda mm: tmodels.HeteroscedasticGPR.ELBO_analytic.__wrapped__(mm))
    assert np.isfinite(val.item())


@pytest.mark.parametrize("method", ["ELBO_analytic", "ELBO_mc"])
def test_hetero_gpr_objectives_match_jax(method):
    X, Y = _hetero()
    pair = Pair(jmodels.HeteroscedasticGPR, tmodels.HeteroscedasticGPR, method, X=X, Y=Y)
    key = jax.random.PRNGKey(7)
    _compare(pair, key, _global_noise(pair.tm, key) if method == "ELBO_mc" else None)


def test_hetero_gpr_predictions_match_jax():
    X, Y = _hetero()
    pair = Pair(jmodels.HeteroscedasticGPR, tmodels.HeteroscedasticGPR, "ELBO_analytic",
                X=X, Y=Y)
    x_new = np.linspace(-0.5, 6.5, 11, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(0)
    _predict(pair, lambda mm: mm.predict_y(x_new), key)
    _predict(pair, lambda mm: mm.predict_g(x_new), key)


def test_hetero_fleet_matches_jax_batched_optimizer():
    """3 HeteroscedasticGPRs (n = 16) through BatchedOptimizer, 5 Adam(0.02)
    steps of the analytic ELBO: under vmap each model's two factors are a
    [3, 16, 16] stack on K1's plain version and the Murray backwards'
    solves on K2's; the per-step fleet objective (rtol 1e-4) and the final
    weights against the JAX package's BatchedOptimizer, the weights with
    the float64 witness (5 Adam steps of the float64 fleet)."""
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve, linalg as tlinalg

    jms = []
    for i in range(3):
        X, Y = _hetero(seed=i)
        jms.append(jmodels.HeteroscedasticGPR(seed=i, X=X, Y=Y))
    jopt = JaxBatched(jms, "ELBO_analytic").compile(optax.adam(0.02))
    start = params_from_jax(jopt._trainable, stacked=True)

    def fleet(dtype):
        tms = [tmodels.HeteroscedasticGPR(seed=i, X=X, Y=Y, device="cpu")
               for i, (X, Y) in enumerate(_hetero(seed=i) for i in range(3))]
        for tm, p in zip(tms, start):
            tm.set_param_dict({k: v.to(dtype) for k, v in p.items()})
        return thb.BatchedOptimizer(tms, "ELBO_analytic").compile(thb.adam(0.02))

    topt = fleet(torch.float32)
    seen = []
    chol, solve = tlinalg._cholesky_dispatch, tlinalg._tri_solve_dispatch

    def spy_chol(A):
        seen.append(("chol", tlinalg._takes_kernel(A), tuple(A.shape)))
        return chol(A)

    def spy_solve(L, R, transpose):
        seen.append(("solve", tlinalg._takes_kernel(L, R), tuple(L.shape)))
        return solve(L, R, transpose)

    tlinalg._cholesky_dispatch, tlinalg._tri_solve_dispatch = spy_chol, spy_solve
    try:
        before = (cuda_chol.cholesky128_vbatched.launches,
                  cuda_solve.tri_solve128_vbatched.launches)
        topt.optimize(maxiter=5)
    finally:
        tlinalg._cholesky_dispatch, tlinalg._tri_solve_dispatch = chol, solve
    # CPU tensors take the plain versions: nothing is launched
    assert before == (cuda_chol.cholesky128_vbatched.launches,
                      cuda_solve.tri_solve128_vbatched.launches)
    # two factors and four backward solves a step, all on the kernels' route
    assert [s[0] for s in seen].count("chol") == 2 * 5
    assert [s[0] for s in seen].count("solve") == 4 * 5
    assert all(s[1] and s[2] == (3, 16, 16) for s in seen)
    jopt.optimize(maxiter=5)
    np.testing.assert_allclose(np.concatenate(topt.history), np.concatenate(jopt.history),
                               rtol=1e-4)
    final64 = []

    def witness(k):
        if not final64:
            cfg = thb.settings.get_settings()
            cfg.dtypes.float_type = torch.float64
            with thb.settings.temp_settings(cfg):
                o = fleet(torch.float64)
                o.optimize(maxiter=5)
                final64.append({kk: v.detach().numpy() for kk, v in o._trainable.items()})
        return final64[0][k]

    for k, want in jopt._trainable.items():
        _held(topt._trainable[k].detach().numpy(), want, lambda: witness(k), k)


# ---------------------------------------------------------- sparse families
def _sparse_data(kind):
    if kind == "hetero":
        X, Y = _hetero(n=64)
        return dict(X=X, Y=Y)
    X, Y, _ = jmodels.make_multioutput_dataset(n=64, seed=1)
    return dict(X=X, Y=Y, Q=2)


SPARSE_CLS = {"hetero": (jmodels.HeteroSVGP, tmodels.HeteroSVGP),
              "multi": (jmodels.MultiOutputSVGP, tmodels.MultiOutputSVGP)}
SPARSE = [("hetero", "ELBO_analytic"), ("hetero", "ELBO_mc"),
          ("multi", "ELBO_analytic"), ("multi", "ELBO_mc")]


@pytest.mark.parametrize("kind,method", SPARSE, ids=["%s-%s" % s for s in SPARSE])
def test_sparse_families_match_jax_on_injected_rows(kind, method):
    pair = Pair(*SPARSE_CLS[kind], method, num_inducing=8, **_sparse_data(kind))
    key = jax.random.PRNGKey(11)
    noise = None
    if method == "ELBO_mc":
        noise = _global_noise(pair.tm, key)
        noise.update(_tagged(key, "sparse_gp_diag", (len(ROWS),), 2 if kind == "hetero" else 1))
    _compare(pair, key, noise, ROWS)


def test_sparse_family_predictions_match_jax():
    x_new = np.linspace(-0.5, 6.5, 9, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(0)
    pair = Pair(*SPARSE_CLS["hetero"], "ELBO_analytic", num_inducing=8,
                **_sparse_data("hetero"))
    _predict(pair, lambda mm: mm.predict_y(x_new), key)
    _predict(pair, lambda mm: mm.predict_g(x_new), key)
    pair = Pair(*SPARSE_CLS["multi"], "ELBO_analytic", num_inducing=8,
                **_sparse_data("multi"))
    _predict(pair, lambda mm: mm.predict_y(x_new), key)
    _predict(pair, lambda mm: mm.output_correlation(), key)
    _predict(pair, lambda mm: mm.output_correlation(x_new), key)


# ------------------------------------------------------------- multi-output
def _multi(**kw):
    X, Y, _ = jmodels.make_multioutput_dataset(n=12, seed=0)
    np.testing.assert_array_equal(Y, tmodels.make_multioutput_dataset(n=12, seed=0)[1])
    return dict(X=X, Y=Y, Q=2, **kw)


MULTI = [(True, "fullrank"), (True, "diagonal"), (False, "fullrank"), (False, "diagonal")]
MULTI_IDS = ["%s-%s" % ("shared" if s else "per_latent", q) for s, q in MULTI]


@pytest.mark.parametrize("shared,q_shape", MULTI, ids=MULTI_IDS)
def test_multioutput_gpr_matches_jax(shared, q_shape):
    """Both ELBOs, predict_f, predict_y and output_correlation; the
    per-latent kernels' ParamList paths carry over one to one."""
    kw = _multi(shared_kernel=shared, q_shape=q_shape)
    key = jax.random.PRNGKey(13)
    for method in ("ELBO_analytic", "ELBO_mc"):
        pair = Pair(jmodels.MultiOutputGPR, tmodels.MultiOutputGPR, method, lr=0.02, **kw)
        if not shared:
            assert {"kern.item0.lengthscales", "kern.item1.lengthscales"} <= set(
                pair.tm.param_dict())
        noise = _global_noise(pair.tm, key) if method == "ELBO_mc" else None
        if noise is not None:
            assert noise["q"].shape == (2, 12)
        _compare(pair, key, noise)
    np.testing.assert_allclose(pair.tm.mix.value, pair.jm.mix.value, rtol=1e-6)
    x_new = np.linspace(-0.5, 6.5, 7, dtype=np.float32)[:, None]
    _predict(pair, lambda mm: mm.predict_f(x_new), key)
    _predict(pair, lambda mm: mm.predict_y(x_new), key)
    _predict(pair, lambda mm: mm.output_correlation(), key)


def test_multioutput_natural_gradient_update_matches_jax():
    """One natural_gradient(0.3, rest=Adam(0.02)) update of the layered
    node from JAX's gradients: the Q = 2 pairs are discovered as the JAX
    package discovers them and stack with the ladder to [6, 12, 12]."""
    pair = Pair(jmodels.MultiOutputGPR, tmodels.MultiOutputGPR, "ELBO_analytic", lr=0.02,
                **_multi())
    jopt, tm = pair.jopt, pair.tm
    tx = jopt_mod.natural_gradient(pair.jm, gamma=0.3, rest=optax.adam(0.02))
    topt = tm.ELBO_analytic().compile(
        topt_mod.natural_gradient(tm, gamma=0.3, rest=thb.adam(0.02)))
    assert [p[:2] for p in topt.torch_optimizer.pairs] == [("q.q_mu", "q.q_sqrt")]
    grads = jax.jit(jax.grad(lambda t, f, d: -jopt._evaluate(t, f, d, None,
                                                             jax.random.PRNGKey(0))))(
        jopt._trainable, jopt._frozen, jopt._data_args())
    upd, _ = jax.jit(tx.update)(grads, tx.init(jopt._trainable), jopt._trainable)
    want = optax.apply_updates(jopt._trainable, upd)
    for k, t in topt._trainable.items():
        t.grad = torch.tensor(np.asarray(grads[k]))
    topt.torch_optimizer.step()
    for k in want:
        _close(topt._trainable[k].detach().numpy(), want[k], k)


# ------------------------------------------------------------------ deep GP
def _step(n=48):
    X, Y = jmodels.make_step_dataset(n=n, seed=0)
    np.testing.assert_array_equal(Y, tmodels.make_step_dataset(n=n, seed=0)[1])
    return X, Y


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_deep_gp_elbo_and_predictions_match_jax(depth):
    """The ELBO on injected rows, predict_f and hidden with the layers'
    correction draws, and predict_y fed JAX's tagged draw
    ``"deepgp_predict_y#0"``."""
    X, Y = _step()
    pair = Pair(jmodels.DeepGPRegression, tmodels.DeepGPRegression, "ELBO",
                X=X, Y=Y, num_inducing=8, depth=depth)
    assert len(pair.tm.layers) == depth
    key = jax.random.PRNGKey(17 + depth)
    noise = _global_noise(pair.tm, key)
    assert sorted(noise) == ["layers.item%d.u" % i for i in range(depth)]
    rows = ROWS[ROWS < 48]
    noise.update(_tagged(key, "sparse_gp_diag", (len(rows),), depth))
    _compare(pair, key, noise, rows)
    x_new = np.linspace(-0.9, 0.9, 7, dtype=np.float32)[:, None]
    noise = _global_noise(pair.tm, key)
    noise.update(_tagged(key, "sparse_gp_diag", (7,), depth))
    _predict(pair, lambda mm: mm.predict_f(x_new), key, noise)
    noise.update(_tagged(key, "deepgp_predict_y", (7, 1), 1))
    _predict(pair, lambda mm: mm.predict_y(x_new), key, noise)
    if depth > 1:
        _predict(pair, lambda mm: mm.hidden(x_new), key, noise)


def test_deep_gp_depth_zero_raises():
    X, Y = _step(n=16)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        tmodels.DeepGPRegression(seed=0, X=X, Y=Y, depth=0, device="cpu")


# ------------------------------------------------------------------- GP-LVM
@pytest.mark.parametrize("q_local", ["diagonal", "fullrank_packed"])
def test_gplvm_matches_jax(q_local):
    """The ELBO (its local/global KL split) on injected rows, latent_mean
    and reconstruct, the encoder's weights carried over."""
    Y, t = jmodels.make_curve_dataset(n=48, seed=0)
    np.testing.assert_array_equal(Y, tmodels.make_curve_dataset(n=48, seed=0)[0])
    pair = Pair(jmodels.GPLVM, tmodels.GPLVM, "ELBO", Y=Y, num_inducing=8, hidden=16,
                q_local=q_local)
    assert any(k.startswith("encoder.") for k in pair.tm.param_dict())
    key = jax.random.PRNGKey(23)
    rows = ROWS[ROWS < 48]
    noise = _global_noise(pair.tm, key)
    noise["t"] = _node_u(key, "t", (len(rows), 1))
    noise.update(_tagged(key, "sparse_gp_diag", (len(rows),), 1))
    _compare(pair, key, noise, rows)
    _predict(pair, lambda mm: mm.latent_mean(Y[:10]), key)
    noise = _global_noise(pair.tm, key)
    noise["t"] = _node_u(key, "t", (10, 1))
    noise.update(_tagged(key, "sparse_gp_diag", (10,), 1))
    _predict(pair, lambda mm: mm.reconstruct(Y[:10]), key, noise)
