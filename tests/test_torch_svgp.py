"""The port's SVGP families (henbun_tpu_torch/models/svgp.py) and
GPR.ELBO_student_quadrature against the JAX package on the CPU.

The same numpy-seeded data (n = 32, m = 6 inducing points), the same
weights (``interop.params_from_jax``), the same minibatch rows and the same
noise: the inducing sample's ``u`` and the sparse GP's correction draws
(``"sparse_gp_diag#0"``), each from JAX's key for its path, injected into
the port. Predictions take the same noise; the deterministic ones
(marginals, quadrature, the multiclass mean with JAX's fixed draws
injected) take none.

Tolerances: objectives rtol 1e-4; each gradient leaf within 1e-4 of its
largest entry; predictions within 1e-4 of their largest entry (float32
sums and solves in another order). One exception, with its reason: the
sparse GP's correction draw scales sqrt(Kdiag - |Lm^-1 k|^2 + jitter),
whose slope is 1 / (2 sqrt(jitter)) = 50 where a row sits on an inducing
point (the quantile init puts z on the end rows), so float32 rounding of
the cancelling difference reaches the gradients of the lengthscale and
of z, whose exact value through that row is 0 (the difference has its
minimum there); where it rounds to exactly 0, the floor's tie rule (half
the slope, as in the JAX package) halves that row's share. Measured
against a float64 evaluation on these cases, the JAX package's float32
values of those two leaves are up to 9.9e-5 of their largest entry off,
the port's up to 8.7e-5; with row 10 left out of the minibatch, the JAX
package's count-ELBO lengthscale gradient is 3.2e-4 off. So on the
objectives that draw the correction (the Monte Carlo ELBOs) those two
leaves are held to the JAX package within ``CORRECTION_TOL`` = 5e-4 of
their largest entry, and, as a second witness that does not share the
JAX package's rounding, to the port's float64 evaluation
(``_float64_grads``, same weights and noise) at the same tolerance; every
other leaf is held to the JAX package at 1e-4.
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import models as jmodels
from henbun_tpu import optimizers as jopt_mod
import henbun_tpu_torch as thb
from henbun_tpu_torch import optimizers as topt_mod
from henbun_tpu_torch.interop import params_from_jax

N = 32
MIND = 6
ROWS = np.random.default_rng(4).choice(N, 16, replace=False)
X_NEW = np.linspace(-0.5, 6.5, 9, dtype=np.float32)[:, None]
CORRECTION_TOL = 5e-4
CORRECTION_LEAVES = ("gp.kern.lengthscales", "gp.z")


def _node_u(key, path, shape):
    k = jax.random.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
    return np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))


def _tagged_u(key, tag, shape, c=0):
    k = jax.random.fold_in(key, zlib.crc32(tag.encode()) & 0x7FFFFFFF)
    return np.asarray(jax.random.normal(jax.random.fold_in(k, c), shape, dtype=jnp.float32))


def _noise(key, u_shape, b):
    return {"u": torch.tensor(_node_u(key, "u", u_shape)),
            "sparse_gp_diag#0": torch.tensor(_tagged_u(key, "sparse_gp_diag", (b,)))}


def _data(kind, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (N, 1))).astype(np.float32)
    f = np.sin(X)
    if kind == "reg":
        Y = (f + 0.3 * rng.normal(size=X.shape)).astype(np.float32)
        Y[::7] += 2.0
    elif kind == "cls":
        Y = (rng.uniform(size=X.shape) < 1 / (1 + np.exp(-3 * f))).astype(np.float32)
    elif kind == "count":
        Y = rng.poisson(np.exp(f)).astype(np.float32)
    else:
        Y = np.clip(np.floor((f + 1.0) * 1.5), 0, 2).astype(np.int32)
    return X, Y


FAMILIES = {
    "reg": ("SVGPRegression", {}),
    "reg_analytic": ("SVGPRegression", {"analytic_kl": True}),
    "reg_diag": ("SVGPRegression", {"q_shape": "diagonal", "analytic_kl": True}),
    "cls": ("SVGPClassification", {}),
    "count": ("SVGPCount", {}),
    "multi": ("SVGPMulticlass", {"num_classes": 3}),
}


def _port(family, method, params):
    """The port's model and optimizer at the configured float type."""
    cls, kw = FAMILIES[family]
    X, Y = _data({"reg_analytic": "reg", "reg_diag": "reg"}.get(family, family))
    tm = getattr(thb.models, cls)(seed=0, X=X, Y=Y, num_inducing=MIND, device="cpu", **kw)
    dtype = thb.settings.dtypes.float_type
    tm.set_param_dict({k: v.to(dtype) for k, v in params.items()})
    return tm, getattr(tm, method)().compile(learning_rate=0.01)


def _pair(family, method="ELBO"):
    cls, kw = FAMILIES[family]
    X, Y = _data({"reg_analytic": "reg", "reg_diag": "reg"}.get(family, family))
    jm = getattr(jmodels, cls)(seed=0, X=X, Y=Y, num_inducing=MIND, **kw)
    jopt = getattr(jm, method)().compile(optax.adam(0.01))
    tm, topt = _port(family, method, params_from_jax(jm.param_dict()))
    return jm, jopt, tm, topt


def _value_and_grads(topt, noise):
    data = topt._take_rows(topt._data_args(), torch.as_tensor(ROWS))
    for t in topt._trainable.values():
        t.grad = None
    val, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, data,
                                     topt.model.generator, noise)
    val.backward()
    return val.item(), {k: t.grad.numpy() for k, t in topt._trainable.items()}


def _float64_grads(family, method, params, noise):
    """The port's gradients evaluated in float64 (same weights and noise)."""
    cfg = thb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with thb.settings.temp_settings(cfg):
        _, topt = _port(family, method, params)
        noise = None if noise is None else {k: v.double() for k, v in noise.items()}
        return _value_and_grads(topt, noise)[1]


def _close(got, want, what, scale=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-6), err_msg=what)


def _compare(jopt, topt, key, noise, f64=None):
    """Objective and gradients against JAX; with the correction noise
    injected, the lengthscale and z gradients at ``CORRECTION_TOL``, and
    against the float64 evaluation of `f64` = (family, method) as well
    (module docstring)."""
    idx = jnp.asarray(ROWS)
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda t, f, d, i, k: jopt._evaluate(t, f, d, i, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), idx, key)
    val_t, g_t = _value_and_grads(topt, noise)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4)
    assert set(g_j) == set(g_t)
    held = ()
    if noise is not None and "sparse_gp_diag#0" in noise:
        params = params_from_jax({k: np.asarray(v) for k, v in jopt._trainable.items()})
        params.update(params_from_jax({k: np.asarray(v) for k, v in jopt._frozen.items()}))
        g64 = _float64_grads(*f64, params, noise)
        held = CORRECTION_LEAVES
        for k in held:
            _close(g_t[k], g_j[k], k, scale=CORRECTION_TOL)
            _close(g_t[k], g64[k], k + " (float64)", scale=CORRECTION_TOL)
    for k, want in g_j.items():
        if k not in held:
            _close(g_t[k], want, k)
    return g_j


OBJECTIVES = [
    ("reg", "ELBO", True), ("reg", "ELBO_analytic", True),
    ("reg_analytic", "ELBO_analytic", False), ("reg_diag", "ELBO_analytic", False),
    ("reg_analytic", "ELBO_student_quadrature", False),
    ("cls", "ELBO", True), ("cls", "ELBO_quadrature", False),
    ("count", "ELBO", True), ("count", "ELBO_analytic", False),
    ("multi", "ELBO", True), ("multi", "ELBO_bound", False),
]


@pytest.mark.parametrize("family,method,mc", OBJECTIVES,
                         ids=["%s-%s" % o[:2] for o in OBJECTIVES])
def test_objective_and_grads_match_jax(family, method, mc):
    _, jopt, tm, topt = _pair(family, method)
    key = jax.random.PRNGKey(17)
    u_shape = (3, MIND) if family == "multi" else (MIND,)
    noise = _noise(key, u_shape, len(ROWS)) if mc else None
    _compare(jopt, topt, key, noise, f64=(family, method))


def _predict(jm, tm, fn_j, fn_t, key, noise):
    want = jm.run(fn_j, key=key)
    got = tm.run(fn_t, noise=noise)
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g.numpy(), w, "output %d" % i)
    else:
        _close(got.numpy(), want, "prediction")


@pytest.mark.parametrize("what", ["f", "y", "marginals"])
def test_regression_predictions_match_jax(what):
    jm, _, tm, _ = _pair("reg_analytic", "ELBO_analytic")
    key = jax.random.PRNGKey(23)
    noise = _noise(key, (MIND,), len(X_NEW))
    if what == "y":
        noise["predict_y#0"] = torch.tensor(_tagged_u(key, "predict_y", (1, len(X_NEW))))
    fn = {"f": lambda mm: mm.predict_f(X_NEW), "y": lambda mm: mm.predict_y(X_NEW),
          "marginals": lambda mm: mm.predict_f_marginals(X_NEW)}[what]
    _predict(jm, tm, fn, fn, key, noise if what != "marginals" else None)


def test_classification_and_count_predictions_match_jax():
    key = jax.random.PRNGKey(29)
    jm, _, tm, _ = _pair("cls", "ELBO_quadrature")
    _predict(jm, tm, lambda mm: mm.predict_p(X_NEW), lambda mm: mm.predict_p(X_NEW), key,
             _noise(key, (MIND,), len(X_NEW)))
    _predict(jm, tm, lambda mm: mm.predict_p_mean(X_NEW), lambda mm: mm.predict_p_mean(X_NEW),
             key, None)
    jm, _, tm, _ = _pair("count", "ELBO_analytic")
    _predict(jm, tm, lambda mm: mm.predict_rate(X_NEW), lambda mm: mm.predict_rate(X_NEW),
             key, None)


def test_multiclass_predictions_match_jax():
    """predict_p under the same noise; predict_p_mean with JAX's fixed
    draws (PRNGKey(0), [num, K, n*]) injected at its path."""
    key = jax.random.PRNGKey(31)
    jm, _, tm, _ = _pair("multi", "ELBO_bound")
    _predict(jm, tm, lambda mm: mm.predict_p(X_NEW), lambda mm: mm.predict_p(X_NEW), key,
             _noise(key, (3, MIND), len(X_NEW)))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 3, len(X_NEW))))
    _predict(jm, tm, lambda mm: mm.predict_p_mean(X_NEW, num=64),
             lambda mm: mm.predict_p_mean(X_NEW, num=64), key,
             {"predict_p_mean": torch.tensor(eps)})
    # uninjected, the draws are fixed: two calls agree exactly
    a = tm.run(lambda mm: mm.predict_p_mean(X_NEW, num=64))
    b = tm.run(lambda mm: mm.predict_p_mean(X_NEW, num=64))
    assert torch.equal(a, b)


def test_gpr_student_quadrature_matches_jax():
    X, Y = jmodels.make_sine_dataset(n=6, seed=0)
    Y[::3] += 2.0
    jm = jmodels.GPR(seed=0, X=X, Y=Y, analytic_kl=True)
    jopt = jm.ELBO_student_quadrature().compile(optax.adam(0.01))
    tm = thb.models.GPR(seed=0, X=X, Y=Y, analytic_kl=True, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = tm.ELBO_student_quadrature().compile(learning_rate=0.01)
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda t, f, d, k: jopt._evaluate(t, f, d, None, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), jax.random.PRNGKey(0))
    val_t, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                       tm.generator, None)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    for k, want in g_j.items():
        _close(topt._trainable[k].grad.numpy(), want, k)


def test_mc_elbo_adaptive_natgrad_update_matches_jax():
    """The MC ELBO with the adaptive natural gradient (the pairing the
    reference records as aborting at n = 1e6): one update at n = 32 from
    the same gradients, and the pair's scale, against JAX."""
    jm, jopt, tm, _ = _pair("reg", "ELBO")
    tx = jopt_mod.natural_gradient(jm, gamma=0.01, rest=optax.adam(0.005), adaptive=True)
    topt = tm.ELBO().compile(
        topt_mod.natural_gradient(tm, gamma=0.01, rest=thb.adam(0.005), adaptive=True))
    key = jax.random.PRNGKey(37)
    g_j = _compare(jopt, topt, key, _noise(key, (MIND,), len(ROWS)), f64=("reg", "ELBO"))
    grads = jax.tree_util.tree_map(lambda g: -g, g_j)
    state = tx.init(jopt._trainable)
    upd, state = jax.jit(tx.update)(grads, state, jopt._trainable)
    want = optax.apply_updates(jopt._trainable, upd)
    for k, t in topt._trainable.items():
        t.grad = torch.tensor(np.asarray(grads[k]))
    topt.torch_optimizer.step()
    for k in want:
        _close(topt._trainable[k].detach().numpy(), want[k], k)
    assert (float(topt.torch_optimizer.state["gamma_scale"]["u.q_mu"])
            == float(state["gamma_scale"]["u.q_mu"]))
