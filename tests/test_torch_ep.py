"""henbun_tpu_torch's expectation propagation (inference/ep.py) against the
JAX package on the CPU.

The same inputs (numpy seeds) and, for the models, the same weights (the
JAX model's ``param_dict()`` after ``initialize()``, carried over by
``interop.params_from_jax``) go through both packages:

* ``ep_gp`` for a Bernoulli likelihood at n = 25 (30 sweeps) and a
  Student-t one at n = 20 (60 sweeps, damping 0.3): every EPResult field
  and the evidence gradient in k_var and the lengthscale, under both
  ``implicit_diff`` modes;
* ``ep_latent_marginals``, ``GPC.predict_p_ep`` and ``GPR.predict_f_ep``;
* a 3-model ``BatchedOptimizer`` on ``GPC.log_marginal_ep`` (n = 25):
  value, gradients and 5 Adam steps against optax;
* the ``ep_delta`` guard, alone and in a fleet, where the diagnostic comes
  out of ``torch.func.vmap``.

Tolerance: values rtol 1e-4, gradients 1e-4 of each leaf's largest entry.
The 60-sweep Student-t EP is the exception for its gradients and sites
(scale 0.3, the data's noise level): float32 holds neither package's to
1e-4 (on this case the two packages' gradients land up to 2.3e-4 of the
leaf from a float64 port evaluation, on either side of it; the last
sweep still moves float32 sites where float64 settles). They are held at
5e-4 against the JAX package, and both packages' float32 results at 5e-4
against float64.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import densities as jdens
from henbun_tpu import models as jmodels
from henbun_tpu.batched import BatchedOptimizer as JaxBatched
from henbun_tpu.inference import ep as jep
import henbun_tpu_torch as thb
from henbun_tpu_torch import densities as tdens
from henbun_tpu_torch.inference import ep as tep
from henbun_tpu_torch.interop import params_from_jax

M = 3
F32_TOL = 5e-4  # the Student-t gradients' and sites' tolerance (module docstring)
SCALE = 0.3     # the Student-t scale: the data's noise level


def _cls_data(n, seed):
    """tests/test_ep.py's classification data."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    p = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p).astype(np.float32)


def _reg_data(n, seed, outliers):
    """tests/test_ep.py's regression data with gross outliers."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    y = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.3
    idx = rng.choice(n, outliers, replace=False)
    y[idx] += rng.choice([-3.0, 3.0], outliers)[:, None]
    return X, y.astype(np.float32)


def _close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6), err_msg=what)


# ------------------------------------------------------------------- ep_gp
CASES = {
    # lik: (data, sweeps, damping)
    "bernoulli": (lambda: _cls_data(25, seed=1), 30, 0.5),
    "student_t": (lambda: _reg_data(20, seed=3, outliers=2), 60, 0.3),
}


def _gram(lib, X, kv, ls):
    d2 = (X - X.T) ** 2
    if lib is jnp:
        return kv * jnp.exp(-0.5 * d2 / ls**2) + 1e-5 * jnp.eye(len(X))
    return kv * torch.exp(-0.5 * d2 / ls**2) + 1e-5 * torch.eye(len(X), dtype=d2.dtype)


def _jax_ep(lik, X, y, implicit):
    _, sweeps, damping = CASES[lik]
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def res(kv, ls):
        if lik == "bernoulli":
            ll = lambda f: yj * jax.nn.log_sigmoid(f) + (1 - yj) * jax.nn.log_sigmoid(-f)
        else:
            ll = lambda f: jdens.student_t(yj, f, jnp.asarray([SCALE]), 3.0)
        return jep.ep_gp(ll, _gram(jnp, Xj, kv, ls), sweeps=sweeps, damping=damping,
                         implicit_diff=implicit)

    return jax.jit(jax.value_and_grad(lambda a, b: (res(a, b).log_marginal, res(a, b)),
                                      argnums=(0, 1), has_aux=True))


def _port_ep(lik, X, y, kv, ls, implicit, dtype=torch.float32):
    _, sweeps, damping = CASES[lik]
    yt = torch.tensor(y, dtype=dtype)
    if lik == "bernoulli":
        ll = lambda f: tdens.bernoulli_logit(yt, f)
    else:
        ll = lambda f: tdens.student_t(yt, f, torch.tensor([SCALE], dtype=dtype), 3.0)
    K = _gram(torch, torch.tensor(X, dtype=dtype), kv, ls)
    return tep.ep_gp(ll, K, sweeps=sweeps, damping=damping, implicit_diff=implicit)


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "unrolled"])
@pytest.mark.parametrize("lik", sorted(CASES))
def test_ep_gp_values_and_gradients_match_jax(lik, implicit):
    X, y = CASES[lik][0]()
    kv0, ls0 = np.float32(1.3), np.float32(0.8)
    (_, want), gwant = _jax_ep(lik, X, y, implicit)(kv0, ls0)
    kv = torch.tensor(kv0, requires_grad=True)
    ls = torch.tensor(ls0, requires_grad=True)
    got = _port_ep(lik, X, y, kv, ls, implicit)
    gk, gl = torch.autograd.grad(got.log_marginal, (kv, ls))
    np.testing.assert_allclose(got.log_marginal.item(), float(want.log_marginal), rtol=1e-4)
    for name in ("f_mean", "f_var"):
        _close(getattr(got, name).detach(), getattr(want, name), name)
    if lik == "bernoulli":
        np.testing.assert_allclose(gk.item(), float(gwant[0]), rtol=1e-4)
        np.testing.assert_allclose(gl.item(), float(gwant[1]), rtol=1e-4)
        for name in ("nu", "tau"):
            _close(getattr(got, name).detach(), getattr(want, name), name)
        assert float(want.delta) < 1e-4 and got.delta.item() < 1e-4
        return
    # Student-t: gradients and sites against JAX and, both packages alike,
    # against float64, at F32_TOL
    kv64 = torch.tensor(float(kv0), dtype=torch.float64, requires_grad=True)
    ls64 = torch.tensor(float(ls0), dtype=torch.float64, requires_grad=True)
    ref = _port_ep(lik, X, y, kv64, ls64, implicit, torch.float64)
    g64 = torch.autograd.grad(ref.log_marginal, (kv64, ls64))
    for name, g, w, r in zip(("k_var", "lengthscale"), (gk, gl), gwant, g64):
        np.testing.assert_allclose(g.item(), float(w), rtol=F32_TOL, err_msg=name)
        np.testing.assert_allclose(g.item(), r.item(), rtol=F32_TOL, err_msg=name + " port/f64")
        np.testing.assert_allclose(float(w), r.item(), rtol=F32_TOL, err_msg=name + " jax/f64")
    for name in ("nu", "tau"):
        g, w, r = getattr(got, name).detach(), getattr(want, name), getattr(ref, name).detach()
        _close(g, w, name, F32_TOL)
        _close(g, r, name + " port/f64", F32_TOL)
        _close(w, r, name + " jax/f64", F32_TOL)
    assert ref.delta.item() < 1e-3
    assert float(want.delta) < 1e-2 and got.delta.item() < 1e-2


def test_implicit_gradient_matches_unrolled():
    """As test_ep.py: at a converged classification fit (60 sweeps) the
    stationarity gradient agrees with the unrolled one (rel 2e-3), and the
    values are equal."""
    X, Y = _cls_data(30, seed=0)
    kv = torch.tensor(1.3, requires_grad=True)
    ls = torch.tensor(0.8)

    def logZ(implicit):
        yt = torch.tensor(Y)
        return tep.ep_gp(lambda f: tdens.bernoulli_logit(yt, f),
                         _gram(torch, torch.tensor(X), kv, ls), sweeps=60,
                         implicit_diff=implicit).log_marginal

    zi, zu = logZ(True), logZ(False)
    assert zi.item() == zu.item()
    gi = torch.autograd.grad(zi, kv)[0].item()
    gu = torch.autograd.grad(zu, kv)[0].item()
    assert abs(gi - gu) / abs(gu) < 2e-3, (gi, gu)


# -------------------------------------------------------------- predictions
def test_ep_latent_marginals_match_jax():
    """ep_latent_marginals on the Student-t result: the Lᵀ solve through the
    solve dispatch; mean and variance rtol 1e-4 of their largest entry."""
    X, y = CASES["student_t"][0]()
    grid = np.linspace(0, 6, 9, dtype=np.float32)[:, None]
    Ks = np.exp(-0.5 * (X - grid.T) ** 2 / 0.8**2).astype(np.float32)
    kd = np.ones(9, np.float32)

    def jfn(Ks, kd):
        res = _jax_ep("student_t", X, y, True)(np.float32(1.0), np.float32(0.8))[0][1]
        return jep.ep_latent_marginals(res, _gram(jnp, jnp.asarray(X), 1.0, 0.8), Ks, kd)

    want = jax.jit(jfn)(Ks, kd)
    with torch.no_grad():
        res = _port_ep("student_t", X, y, torch.tensor(1.0), torch.tensor(0.8), True)
        got = tep.ep_latent_marginals(res, _gram(torch, torch.tensor(X), 1.0, 0.8),
                                      torch.tensor(Ks), torch.tensor(kd))
    for name, g, w in zip(("mean", "var"), got, want):
        assert g.shape == (9, 1)
        _close(g, w, name)


def _pair(kind):
    if kind == "gpc":
        X, Y = _cls_data(25, seed=2)
        jm, tm = (jmodels.GPC(seed=0, X=X, Y=Y),
                  thb.models.GPC(seed=0, X=X, Y=Y, device="cpu"))
    else:
        X, Y = _reg_data(20, seed=4, outliers=2)
        jm, tm = (jmodels.GPR(seed=0, X=X, Y=Y),
                  thb.models.GPR(seed=0, X=X, Y=Y, device="cpu"))
    jm.initialize()
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jm, tm


@pytest.mark.parametrize("kind", ["gpc", "gpr"])
def test_model_ep_predictions_and_evidence_match_jax(kind):
    """GPC.predict_p_ep (p rtol 1e-4) and GPR.predict_f_ep (mean, var 1e-4
    of the largest entry) at the same weights, with each model's EP
    evidence (rtol 1e-4)."""
    jm, tm = _pair(kind)
    grid = np.linspace(0, 6, 7, dtype=np.float32)[:, None]
    if kind == "gpc":
        want = jax.jit(lambda g: jm.run(lambda mm: mm.predict_p_ep(g)))(grid)
        got = tm.run(lambda mm: mm.predict_p_ep(grid))
        assert got.shape == (7, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
        method = "log_marginal_ep"
    else:
        want = jax.jit(lambda g: jm.run(lambda mm: mm.predict_f_ep(g)))(grid)
        got = tm.run(lambda mm: mm.predict_f_ep(grid))
        for name, g, w in zip(("mean", "var"), got, want):
            assert g.shape == (7, 1)
            _close(g, w, name)
        method = "log_marginal_ep_student"
    ev_j = float(getattr(jm, method)().compile(optax.adam(0.01)).run())
    ev_t = float(getattr(tm, method)().compile(learning_rate=0.01).run())
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-4)


# ------------------------------------------------------------------- fleet
def _fleets():
    jms, tms = [], []
    for i in range(M):
        X, Y = _cls_data(25, seed=10 + i)
        jms.append(jmodels.GPC(seed=i, X=X, Y=Y))
        tms.append(thb.models.GPC(seed=i, X=X, Y=Y, device="cpu"))
    jopt = JaxBatched(jms, "log_marginal_ep").compile(optax.adam(0.05))
    for tm, p in zip(tms, params_from_jax(jopt._trainable, stacked=True)):
        tm.set_param_dict(p)
    return jopt, thb.BatchedOptimizer(tms, "log_marginal_ep").compile(learning_rate=0.05)


def test_fleet_value_grad_and_adam_steps_match_jax():
    """The 3-model GPC fleet of test_ep.py on its EP evidence: the summed
    evidence and every model's gradients (rtol 1e-4, 1e-4 of the leaf's
    largest entry), then 5 Adam steps against 5 optax steps (objectives
    rtol 1e-4, parameters rtol 1e-4 / atol 1e-5). The JAX objective is
    jitted with the data and frozen weights as arguments."""
    jopt, topt = _fleets()
    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))
    frozen, data = jopt._frozen, jopt._data_args()
    vg = lambda t: fn(t, frozen, data)
    val_j, g_j = vg(jopt._trainable)
    val_t, diags = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                           topt.model.generator, None)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    assert set(g_j) == set(topt._trainable) and diags["ep_delta"].shape == ()
    for k, want in g_j.items():
        _close(topt._trainable[k].grad, want, k)

    tx = optax.adam(0.05)
    t, objs = jopt._trainable, []
    state = tx.init(t)
    for _ in range(5):
        val, g = vg(t)
        upd, state = tx.update(jax.tree_util.tree_map(lambda a: -a, g), state, t)
        t = optax.apply_updates(t, upd)
        objs.append(float(val))
    topt.optimize(maxiter=5)
    np.testing.assert_allclose(topt.history[-1], objs, rtol=1e-4)
    for k, want in t.items():
        np.testing.assert_allclose(topt._trainable[k].detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------------- guard
class _FewSweeps(thb.models.GPC):
    @thb.AutoOptimize()
    def log_marginal_ep_undercooked(self):
        return tep.ep_gp(self._loglik(), self._K(), sweeps=2, damping=0.9).log_marginal


def _guard_opt(cls, method, fleet):
    thb.set_seed(0)
    ms = []
    for i in range(2 if fleet else 1):
        X, Y = _cls_data(40, seed=1 + i)
        ms.append(cls(seed=i, X=X, Y=Y, device="cpu"))
    if fleet:
        return thb.BatchedOptimizer(ms, method).compile(learning_rate=0.05)
    return getattr(ms[0], method)().compile(learning_rate=0.05)


@pytest.mark.parametrize("fleet", [False, True], ids=["single", "fleet"])
def test_too_few_sweeps_abort_with_the_hint(fleet):
    """test_ep.py's guard: a 2-sweep objective aborts, naming ep_delta,
    sweeps and damping; in a fleet the diagnostic comes out of vmap as the
    fleet's maximum."""
    opt = _guard_opt(_FewSweeps, "log_marginal_ep_undercooked", fleet)
    with pytest.raises(FloatingPointError) as e:
        opt.optimize(maxiter=4)
    msg = str(e.value)
    assert "ep_delta" in msg and "sweeps" in msg and "damping" in msg


@pytest.mark.parametrize("fleet", [False, True], ids=["single", "fleet"])
def test_converged_run_records_ep_delta(fleet):
    opt = _guard_opt(thb.models.GPC, "log_marginal_ep", fleet)
    opt.optimize(maxiter=4)
    rows = opt.metrics.rows
    assert rows and "ep_delta" in rows[-1]
    assert rows[-1]["ep_delta"] < 1e-2
