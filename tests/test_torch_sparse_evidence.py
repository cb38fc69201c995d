"""henbun_tpu_torch's sparse evidence families (models.SparseGPC,
models.SparseGPRobust), the projected EP engine and the inducing-point
guard against the JAX package on the CPU.

Both packages get the same data (numpy seeds) and the same weights (the
JAX model's ``param_dict()`` after ``initialize()``, frozen ``gp.z``
included, carried over by ``interop.params_from_jax``):

* ``SparseGPC`` at n = 200, m = 12: Laplace and EP evidence with their
  gradients, ``predict_p`` and ``predict_p_ep``;
* ``SparseGPRobust`` at n = 200, m = 12 with 4% gross outliers: Laplace
  evidence, the unrolled EP evidence (60 sweeps) and ``log_posterior``
  with their gradients, ``predict_f`` and ``predict_f_ep``;
* a 3-model ``SparseGPC`` fleet at n = 48, m = 12, whose Newton forward
  goes through K3's plain version, against the JAX package's vmapped
  fleet;
* ``z_min_spacing``, ``z_repulsion`` (value and gradient, an exactly
  coincident pair included) and a ``train_z=True`` objective with its z
  gradient;
* the exactness anchor (port only, as test_gpc.py and test_ep.py): with
  z = X, SparseGPC reproduces the dense GPC's Laplace and EP evidence.

Tolerance: values rtol 1e-4, gradients 1e-4 of each leaf's largest entry;
the unrolled robust EP's gradients are held to a float64 port evaluation
at 1e-4 and to the JAX package at 2e-4 (see its test). The JAX objectives
are jitted with data and weights as arguments.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import models as jmodels
from henbun_tpu.batched import BatchedOptimizer as JaxBatched
from henbun_tpu.gp import gp as jgp
from henbun_tpu.inference import laplace as jlap
import henbun_tpu_torch as thb
from henbun_tpu_torch.gp import gp as tgp
from henbun_tpu_torch.interop import params_from_jax
from henbun_tpu_torch.models._zguard import z_guard
from henbun_tpu_torch.ops import cuda_newton

N, M_IND = 200, 12


def _cls(n, seed):
    """test_train_z.py's data: sorted U[0, 6] inputs, labels from
    sigmoid(3 sin x)."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p_true).astype(np.float32)


def _outlier_bed(n, seed=3):
    """test_laplace.py's outlier bed: sin(x) + 0.2 N(0, 1), 4% of the rows
    moved by +-4."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    Y = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.2
    idx = rng.choice(n, n // 25, replace=False)
    Y[idx] += rng.choice([-4.0, 4.0], len(idx))[:, None]
    return X, Y.astype(np.float32)


def _close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6), err_msg=what)


def _pair(kind, **kw):
    if kind == "gpc":
        X, Y = _cls(N, seed=0)
        jm = jmodels.SparseGPC(seed=0, X=X, Y=Y, num_inducing=M_IND, **kw)
        tm = thb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=M_IND, device="cpu", **kw)
    else:
        X, Y = _outlier_bed(N)
        jm = jmodels.SparseGPRobust(seed=0, X=X, Y=Y, num_inducing=M_IND, **kw)
        tm = thb.models.SparseGPRobust(seed=0, X=X, Y=Y, num_inducing=M_IND, device="cpu", **kw)
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jm, tm


def _jax_value_and_grad(jopt):
    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))
    return fn(jopt._trainable, jopt._frozen, jopt._data_args())


def _port_value_and_grad(topt):
    val, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                     topt.model.generator, None)
    val.backward()
    return val.item(), {k: t.grad for k, t in topt._trainable.items()}


def _float64_grads(tm, method, params):
    """The port's gradients of `method` evaluated in float64 at the same
    weights and data."""
    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with thb.settings.temp_settings(cfg):
        m64 = type(tm)(seed=0, X=tm.x.value, Y=tm.y.value, num_inducing=M_IND, device="cpu")
        m64.set_param_dict({k: v.double() for k, v in params.items()})
        return _port_value_and_grad(getattr(m64, method)().compile(learning_rate=0.05))[1]


def _check_objective(jm, tm, method, f64_tol=None):
    """Value and gradients against the JAX package; with `f64_tol`, each
    package's float32 gradients within f64_tol of the leaf against the
    port's float64 evaluation, and the two packages within twice that."""
    jopt = getattr(jm, method)().compile(optax.adam(0.05))
    topt = getattr(tm, method)().compile(learning_rate=0.05)
    val_j, g_j = _jax_value_and_grad(jopt)
    val_t, g_t = _port_value_and_grad(topt)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4, err_msg=method)
    assert set(g_j) == set(g_t)
    g64 = _float64_grads(tm, method, params_from_jax(jm.param_dict())) if f64_tol else {}
    for k, want in g_j.items():
        what = "%s %s" % (method, k)
        if not f64_tol:
            _close(g_t[k], want, what)
            continue
        _close(g_t[k], g64[k], what + " port/f64", f64_tol)
        _close(want, g64[k], what + " jax/f64", f64_tol)
        _close(g_t[k], want, what, 2 * f64_tol)


_JAX_WITH_FLOOR = jlap._with_floor


def _ep_reference(monkeypatch, method):
    """The port's projected EP floors P = I + A^T T A at the Laplace
    engine's base, 1e-6, where the JAX package passes the jitter level
    (ROADMAP Queue 3): its JAX reference is the JAX package with that
    floor."""
    if method.endswith("_ep"):
        monkeypatch.setattr(jlap, "_with_floor", lambda B, base=1e-6: _JAX_WITH_FLOOR(B))


@pytest.mark.parametrize("method", ["log_marginal_laplace", "log_marginal_ep", "log_posterior"])
def test_sparse_gpc_objectives_match_jax(monkeypatch, method):
    jm, tm = _pair("gpc")
    _ep_reference(monkeypatch, method)
    _check_objective(jm, tm, method)


def test_projected_ep_gradient_is_the_derivative_of_its_value():
    """In float64, the projected EP's k_var gradient (reverse mode through
    60 sweeps, and the fixed-point one) is within 2e-5 of a central finite
    difference of its evidence: the floor's gradient is stopped, and at
    base 1e-6 it is too small to matter. At the JAX package's base (the
    jitter level, 1e-4) the stopped floor makes the gradient miss the
    derivative by more than 1e-4 (2.5e-4 here, 1% at n = 2,000)."""
    from henbun_tpu_torch.inference import ep as tep
    from henbun_tpu_torch.inference.laplace import _with_floor

    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    X, Y = _cls(N, seed=0)
    with thb.settings.temp_settings(cfg):
        thb.set_seed(0)  # the initial weights; the stopped floor's share grows with k_var
        tm = thb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=M_IND, device="cpu")
        tm.initialize()
        p0 = tm.param_dict()

        def evidence(dkv, implicit=False):
            tm.set_param_dict({**p0, "k_var": p0["k_var"] + dkv})
            opt = thb.model.Optimizer(tm, lambda mm: tep.ep_gp_projected(
                mm._loglik(), mm._A(mm.x), sweeps=60, implicit_diff=implicit).log_marginal)
            return _port_value_and_grad(opt.compile())

        def miss(implicit=False):
            h = 1e-5
            fd = (evidence(h)[0] - evidence(-h)[0]) / (2 * h)
            return abs(evidence(0.0, implicit)[1]["k_var"].item() - fd) / abs(fd)

        assert miss() < 2e-5 and miss(implicit=True) < 2e-5
        real = tep._floored
        tep._floored = lambda P: _with_floor(P, 1e-4)
        try:
            assert miss() > 1e-4
        finally:
            tep._floored = real


@pytest.mark.parametrize("method", ["log_marginal_laplace", "log_marginal_ep", "log_posterior"])
def test_sparse_robust_objectives_match_jax(monkeypatch, method):
    """log_marginal_ep differentiates through the 60 unrolled Student-t
    sweeps: there the two packages' float32 k_var gradients fall on either
    side of float64's (JAX 3.6e-5, the port 8.2e-5 of the leaf away; 1.2e-4
    apart), so each is held to the port's float64 evaluation at 1e-4 and
    the two to each other at 2e-4."""
    jm, tm = _pair("robust")
    _ep_reference(monkeypatch, method)
    _check_objective(jm, tm, method, f64_tol=1e-4 if method == "log_marginal_ep" else None)


@pytest.mark.parametrize("kind,method", [
    ("gpc", "predict_p"), ("gpc", "predict_p_ep"),
    ("robust", "predict_f"), ("robust", "predict_f_ep"),
])
def test_sparse_predictions_match_jax(monkeypatch, kind, method):
    """Predictions at 9 new inputs, the residual (FITC) variance restored:
    each output rtol 1e-4 of its largest entry."""
    jm, tm = _pair(kind)
    _ep_reference(monkeypatch, method)
    grid = np.linspace(0.1, 5.9, 9, dtype=np.float32)[:, None]
    want = jax.jit(lambda g: jm.run(lambda mm: getattr(mm, method)(g)))(grid)
    got = tm.run(lambda mm: getattr(mm, method)(grid))
    if kind == "gpc":
        want, got = (want,), (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (9, 1) and torch.isfinite(g).all()
        _close(g, w, "%s[%d]" % (method, i))


def test_sparse_fleet_goes_through_k3_and_matches_jax(monkeypatch):
    """3 SparseGPCs at n = 48, m = 12 on the Laplace evidence: the fleet's
    Newton forward reaches the K3 wrapper once a evaluation with the
    rectangular [3, 48, 12] batch (its plain version on the CPU); value and
    gradients against the JAX package's vmapped fleet, then 3 Adam steps
    (objectives rtol 1e-4, parameters rtol 1e-4 / atol 1e-5)."""
    calls = []
    real = cuda_newton.newton_mode_vbatched
    monkeypatch.setattr(cuda_newton, "newton_mode_vbatched",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    jms, tms = [], []
    for i in range(3):
        X, Y = _cls(48, seed=20 + i)
        jms.append(jmodels.SparseGPC(seed=i, X=X, Y=Y, num_inducing=M_IND))
        tms.append(thb.models.SparseGPC(seed=i, X=X, Y=Y, num_inducing=M_IND, device="cpu"))
    jopt = JaxBatched(jms, "log_marginal_laplace").compile(optax.adam(0.05))
    for tm, p, fr in zip(tms, params_from_jax(jopt._trainable, stacked=True),
                         params_from_jax(jopt._frozen, stacked=True)):
        tm.set_param_dict({**p, **fr})
    topt = thb.BatchedOptimizer(tms, "log_marginal_laplace").compile(learning_rate=0.05)
    assert calls and set(calls) == {(3, 48, M_IND)}
    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))
    vg = lambda t: fn(t, jopt._frozen, jopt._data_args())
    val_j, g_j = vg(jopt._trainable)
    calls.clear()
    val_t, g_t = _port_value_and_grad(topt)
    assert calls == [(3, 48, M_IND)]
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4)
    for k, want in g_j.items():
        _close(g_t[k], want, k)

    tx = optax.adam(0.05)
    t, objs = jopt._trainable, []
    state = tx.init(t)
    for _ in range(3):
        val, g = vg(t)
        upd, state = tx.update(jax.tree_util.tree_map(lambda a: -a, g), state, t)
        t = optax.apply_updates(t, upd)
        objs.append(float(val))
    topt.optimize(maxiter=3)
    np.testing.assert_allclose(topt.history[-1], objs, rtol=1e-4)
    for k, want in t.items():
        np.testing.assert_allclose(topt._trainable[k].detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ z guard
def _near_pair(coincident):
    z = np.linspace(0, 1, 8)[:, None].astype(np.float32)
    d0 = 0.5 * jgp.z_min_spacing(z)
    z[3] = z[4] if coincident else z[4] - 1e-4
    return z, d0


@pytest.mark.parametrize("coincident", [False, True], ids=["near", "coincident"])
def test_z_repulsion_value_and_gradient_match_jax(coincident):
    """test_train_z.py's pairs: the barrier's value rtol 1e-4 and gradient
    1e-4 of its largest entry; only the pair feels a force, and the
    gradient is finite at an exactly coincident pair."""
    z, d0 = _near_pair(coincident)
    assert tgp.z_min_spacing(z) == jgp.z_min_spacing(z)
    want, gwant = jax.jit(jax.value_and_grad(lambda zz: jgp.z_repulsion(zz, d0, 100.0)))(z)
    zt = torch.tensor(z, requires_grad=True)
    got = tgp.z_repulsion(zt, d0, 100.0)
    (g,) = torch.autograd.grad(got, zt)
    assert torch.isfinite(got) and torch.isfinite(g).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    _close(g, gwant, "z gradient")
    others = np.r_[g[:3, 0].numpy(), g[5:, 0].numpy()]
    assert np.abs(others).max() == 0.0


def test_z_min_spacing_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.uniform(0, 6, (16, 2)).astype(np.float32)
    assert tgp.z_min_spacing(z) == jgp.z_min_spacing(z)
    assert tgp.z_min_spacing(torch.tensor(z)) == jgp.z_min_spacing(z)
    assert tgp.z_min_spacing(np.zeros((3, 1), np.float32)) == 0.0


def test_train_z_objective_and_z_gradient_match_jax():
    """train_z=True with a pair moved inside the barrier's onset: z is a
    trainable leaf in free space scaled by 5 d0, the objective subtracts
    the barrier, and both the objective and its z gradient match the JAX
    package (the barrier's share of the z gradient is checked to be
    nonzero)."""
    jm, tm = _pair("gpc", train_z=True)
    assert tm._z_d0 == pytest.approx(jm._z_d0) and tm._z_rep_weight == jm._z_rep_weight
    z = np.asarray(jm.gp.z.value).copy()
    z[5] = z[6] - 0.2 * jm._z_d0
    jm.gp.z = z
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    _check_objective(jm, tm, "log_marginal_laplace")
    barrier = tm.run(z_guard)
    assert barrier.item() > 0


# -------------------------------------------------------- exactness at z = X
def test_z_equal_x_reproduces_dense_gpc():
    """With z = X the projected prior A A^T is the exact gram: the sparse
    Laplace and EP evidences equal the dense GPC's within 1e-3 relative
    (test_gpc.py's and test_ep.py's anchor, port only)."""
    from henbun_tpu_torch.inference.ep import ep_gp, ep_gp_projected
    from henbun_tpu_torch.inference.laplace import laplace_whitened

    X, Y = _cls(50, seed=0)
    thb.set_seed(0)
    dense = thb.models.GPC(seed=0, X=X, Y=Y, device="cpu")
    dense.initialize()
    sp = thb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=len(X), device="cpu")
    sp.gp.z = X.copy()
    sp.k_var = np.asarray(dense.k_var.value)
    sp.gp.kern.lengthscales = np.asarray(dense.kern.lengthscales.value)
    sp.initialize()
    pairs = {
        "laplace": (lambda m: laplace_whitened(m._loglik(), m._Lk()).log_marginal,
                    lambda m: laplace_whitened(m._loglik(), m._A(m.x)).log_marginal),
        "ep": (lambda m: ep_gp(m._loglik(), m._K()).log_marginal,
               lambda m: ep_gp_projected(m._loglik(), m._A(m.x)).log_marginal),
    }
    for name, (fd, fs) in pairs.items():
        e_d, e_s = dense.run(fd).item(), sp.run(fs).item()
        assert abs(e_d - e_s) < 1e-3 * abs(e_d), (name, e_d, e_s)
