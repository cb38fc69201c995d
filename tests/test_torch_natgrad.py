"""The port's natural gradient (henbun_tpu_torch/optimizers.py) against the
JAX package's optax transformation on the CPU.

One update takes the same weights (``interop.params_from_jax``) and the
same gradients (JAX's gradient of the minimized -objective, written into
each port tensor's ``.grad``), so what is compared is the update rule
itself: the VJP to the expectation parameters, the two factorizations and
inverses (the plain versions of K1 and K2 here), the retry ladder, the
adaptive scale and the ``rest`` optimizer. Small shapes: GPR at n = 6
(q over m = 6), fleets of M = 3.

Tolerance: every leaf within rtol 1e-4 of its largest entry (two float32
factorizations and inverses taken in another order).
"""
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
import henbun_tpu_torch as thb
from henbun_tpu_torch import optimizers as topt_mod
from henbun_tpu_torch.interop import params_from_jax

N = 6
M = 3


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=what,
    )


def _jax_grads(jopt, key=None):
    """Gradient of the minimized -objective at JAX's weights (what the
    training loop hands the transformation)."""
    key = jax.random.PRNGKey(0) if key is None else key
    return jax.jit(jax.grad(lambda t, f, d, k: -jopt._evaluate(t, f, d, None, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), key
    )


def _jax_update(tx, params, grads, state=None):
    """One jitted update (init fills the pair table the trace reads)."""
    state = tx.init(params) if state is None else state
    upd, state = jax.jit(tx.update)(grads, state, params)
    return optax.apply_updates(params, upd), state


def _port_step(topt, grads):
    """One step of the port's optimizer with the given gradients."""
    for k, t in topt._trainable.items():
        t.grad = torch.tensor(np.asarray(grads[k]))
    topt.torch_optimizer.step()
    return {k: t.detach().numpy() for k, t in topt._trainable.items()}


def _gpr_pair(q_shape, gamma):
    X, Y = jmodels.make_sine_dataset(n=N, seed=0)
    jm = jmodels.GPR(seed=0, X=X, Y=Y, q_shape=q_shape, analytic_kl=True)
    jopt = jm.ELBO_analytic().compile(optax.adam(0.01))
    tx = jopt_mod.natural_gradient(jm, gamma=gamma, rest=optax.adam(0.01))
    tm = thb.models.GPR(seed=0, X=X, Y=Y, q_shape=q_shape, analytic_kl=True, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = tm.ELBO_analytic().compile(
        topt_mod.natural_gradient(tm, gamma=gamma, rest=thb.adam(0.01))
    )
    return jopt, tx, topt


@pytest.mark.parametrize("q_shape", ["diagonal", "fullrank", "fullrank_packed"])
def test_one_update_matches_jax(q_shape):
    jopt, tx, topt = _gpr_pair(q_shape, gamma=0.5)
    grads = _jax_grads(jopt)
    want, _ = _jax_update(tx, jopt._trainable, grads)
    got = _port_step(topt, grads)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    # the pair is the natgrad's, the rest Adam's
    assert [p[:2] for p in topt.torch_optimizer.pairs] == [("q.q_mu", "q.q_sqrt")]


@pytest.mark.parametrize("q_shape", ["diagonal", "fullrank", "fullrank_packed"])
def test_fleet_update_matches_jax(q_shape):
    """M = 3 GPRs under BatchedOptimizer: the stacked [M, ...] pairs flatten
    into one stack, one factorization call for the fleet."""
    jms, tms = [], []
    for i in range(M):
        X, Y = jmodels.make_sine_dataset(n=N, seed=i)
        jms.append(jmodels.GPR(seed=i, X=X, Y=Y, q_shape=q_shape, analytic_kl=True))
        tms.append(thb.models.GPR(seed=i, X=X, Y=Y, q_shape=q_shape, analytic_kl=True,
                                  device="cpu"))
    jopt = JaxBatched(jms, "ELBO_analytic").compile(optax.adam(0.01))
    tx = jopt_mod.natural_gradient(jms[0], gamma=0.5, rest=optax.adam(0.01))
    for tm, p in zip(tms, params_from_jax(jopt._trainable, stacked=True)):
        tm.set_param_dict(p)
    topt = thb.BatchedOptimizer(tms, "ELBO_analytic").compile(
        topt_mod.natural_gradient(tms[0], gamma=0.5, rest=thb.adam(0.01))
    )
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    grads = _jax_grads(jopt)
    want, _ = _jax_update(tx, jopt._trainable, grads)
    before = (cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches)
    got = _port_step(topt, grads)
    # CPU tensors take the plain versions: nothing is launched here
    assert before == (cuda_chol.cholesky128_vbatched.launches,
                      cuda_solve.tri_solve128_vbatched.launches)
    for k in want:
        _close(got[k], want[k], k)


def _cone_case():
    """Three distributions (m = 2, mu = 0, L = I, gmu = 0, gL = c I): c = 0.5
    succeeds at gamma = 1, c = 4 leaves the cone there and comes back at
    gamma/8 (tests/test_natgrad.py), c = 100 fails at every rung."""
    m = 2
    cs = np.array([0.5, 4.0, 100.0], np.float32)
    mu = np.zeros((3, m), np.float32)
    L = np.broadcast_to(np.eye(m, dtype=np.float32), (3, m, m)).copy()
    gmu = np.zeros((3, m), np.float32)
    gL = cs[:, None, None] * np.eye(m, dtype=np.float32)
    return mu, L, gmu, gL


def test_cone_exit_is_rescued_by_the_ladder_as_in_jax():
    mu, L, gmu, gL = _cone_case()
    want = jax.vmap(lambda a, b, c, d: jopt_mod._natgrad_full(a, b, c, d, 1.0))(
        jnp.asarray(mu), jnp.asarray(L), jnp.asarray(gmu), jnp.asarray(gL)
    )
    got = topt_mod._natgrad_full(*(torch.tensor(a) for a in (mu, L, gmu, gL)), 1.0)
    # ok, first_ok, rescued per distribution: (T, T, F), (T, F, F), (F, T, F)
    for name, g, w in zip(("ok", "first_ok", "rescued"), got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), [True, True, False])
    np.testing.assert_array_equal(got[4].numpy(), [False, True, False])
    # a distribution whose whole ladder failed keeps its old value; the
    # JAX function returns the last attempt there and its _batched keeps
    # the old one
    ok = np.asarray(want[2])
    for g, w, old in ((got[0], want[0], mu), (got[1], want[1], L)):
        w = np.where(ok.reshape((-1,) + (1,) * (w.ndim - 1)), np.asarray(w), old)
        _close(g.numpy(), w, "ladder")
    assert not np.allclose(got[1][1].numpy(), L[1])  # the rescued one moved


class _JaxLinearVI(jhb.model.Model):
    """Linear-Gaussian VI with a fully analytic ELBO
    (tests/test_natgrad.py::AnalyticLinearVI)."""

    def setUp(self, A, y, var):
        self.A = jhb.Data(A)
        self.y = jhb.Data(y)
        self.noise_var = float(var)
        self.q = jhb.variationals.Normal(
            shape=[A.shape[1]], q_shape="fullrank", analytic_kl=True
        )

    @jhb.AutoOptimize()
    def ELBO(self):
        from henbun_tpu import densities

        q = self.__dict__["q"]
        L = jnp.tril(q.q_sqrt)
        ell = jnp.sum(
            densities.gaussian(self.y, self.A @ q.q_mu, jnp.asarray(self.noise_var))
        ) - 0.5 * jnp.sum(jnp.square(self.A @ L)) / self.noise_var
        return ell - self.KL()


class _PortLinearVI(thb.Model):
    def setUp(self, A, y, var):
        self.A = thb.Data(A)
        self.y = thb.Data(y)
        self.noise_var = float(var)
        self.q = thb.variationals.Normal(
            shape=[A.shape[1]], q_shape="fullrank", analytic_kl=True
        )

    @thb.AutoOptimize()
    def ELBO(self):
        q = self.__dict__["q"]
        L = torch.tril(q.q_sqrt)
        ell = torch.sum(
            thb.densities.gaussian(self.y, self.A @ q.q_mu, self.noise_var)
        ) - 0.5 * torch.sum(torch.square(self.A @ L)) / self.noise_var
        return ell - self.KL()


def _linear_problem(n=40, d=6, var=0.1, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = (A @ w + rng.normal(size=(n,)).astype(np.float32) * np.sqrt(var)).astype(np.float32)
    P = A.T @ A / var + np.eye(d)
    Sigma_opt = np.linalg.inv(P)
    return A, y, var, Sigma_opt @ (A.T @ y / var), Sigma_opt


def test_one_step_convergence_on_the_analytic_elbo():
    """A deterministic conjugate ELBO: two unit steps of the port's natural
    gradient land on the closed-form posterior (tests/test_natgrad.py's
    bar, atol 1e-3)."""
    A, y, var, mu_opt, Sigma_opt = _linear_problem()
    thb.set_seed(0)
    m = _PortLinearVI(seed=0, A=A, y=y, var=var, device="cpu")
    opt = m.ELBO().compile(topt_mod.natural_gradient(m, gamma=1.0))
    opt.optimize(maxiter=2)
    mu = m.q.q_mu.value
    L = np.tril(m.q.q_sqrt.value)
    np.testing.assert_allclose(mu, mu_opt, atol=1e-3)
    np.testing.assert_allclose(L @ L.T, Sigma_opt, atol=1e-3)


def test_adaptive_scale_after_three_steps_matches_jax():
    """gamma = 1.5 from a tight q (L = 0.05 I) leaves the cone on the first
    step and is rescued at gamma/8: the scale shrinks 8x, then recovers.
    Three steps, each with its own gradients in each package; the scale
    and every parameter against JAX."""
    A, y, _, _, _ = _linear_problem(var=10.0, seed=1)
    jm = _JaxLinearVI(seed=0, A=A, y=y, var=10.0)
    jm.q.q_sqrt = 0.05 * np.eye(A.shape[1], dtype=np.float32)
    jopt = jm.ELBO().compile(optax.adam(0.01))
    tx = jopt_mod.natural_gradient(jm, gamma=1.5, adaptive=True)
    tm = _PortLinearVI(seed=0, A=A, y=y, var=10.0, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = tm.ELBO().compile(topt_mod.natural_gradient(tm, gamma=1.5, adaptive=True))
    params, state, scales = jopt._trainable, None, []
    data = jopt._data_args()
    grad = jax.jit(jax.grad(lambda t, f, d, k: -jopt._evaluate(t, f, d, None, k)))
    for _ in range(3):
        g = grad(params, jopt._frozen, data, jax.random.PRNGKey(0))
        params, state = _jax_update(tx, params, g, state)
        for t in topt._trainable.values():
            t.grad = None
        val, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                         tm.generator, None)
        (-val).backward()
        topt.torch_optimizer.step()
        scales.append(float(topt.torch_optimizer.state["gamma_scale"]["q.q_mu"]))
        assert scales[-1] == float(state["gamma_scale"]["q.q_mu"])
    assert scales[0] == 0.125  # rescued on the first step
    for k in params:
        _close(topt._trainable[k].detach().numpy(), params[k], k)


class _JaxBetaModel(jhb.model.Model):
    def setUp(self):
        self.p = jhb.variationals.Beta(shape=[3])

    @jhb.AutoOptimize()
    def obj(self):
        from henbun_tpu import densities

        y = jnp.asarray([0.2, 0.5, 0.8], jnp.float32)
        return jnp.sum(densities.gaussian(y, self.p, jnp.asarray(0.05))) - self.KL()


class _PortBetaModel(thb.Model):
    def setUp(self):
        self.p = thb.variationals.Beta(shape=[3])

    @thb.AutoOptimize()
    def obj(self):
        y = torch.tensor([0.2, 0.5, 0.8])
        return torch.sum(thb.densities.gaussian(y, self.p, 0.05)) - self.KL()


def test_beta_node_value_grad_and_update_match_jax():
    """Beta: the objective and its gradients under the same noise, then
    one natural-gradient update; alpha and beta are left to `rest`."""
    import zlib

    jm = _JaxBetaModel(seed=0)
    jopt = jm.obj().compile(optax.adam(0.02))
    tm = _PortBetaModel(seed=0, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = tm.obj().compile(topt_mod.natural_gradient(tm, gamma=0.01, rest=thb.adam(0.02)))
    key = jax.random.PRNGKey(3)
    u = jax.random.normal(jax.random.fold_in(key, zlib.crc32(b"p") & 0x7FFFFFFF), (3,))
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda t, f, d, k: jopt._evaluate(t, f, d, None, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), key)
    val_t, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                       tm.generator, {"p": torch.tensor(np.asarray(u))})
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    for k in g_j:
        _close(topt._trainable[k].grad.numpy(), g_j[k], k)
    assert [p[:2] for p in topt.torch_optimizer.pairs] == [("p.q_mu", "p.q_sqrt")]
    rest = {id(p) for g in topt.torch_optimizer.rest.param_groups for p in g["params"]}
    assert rest == {id(topt._trainable[k]) for k in ("p.alpha", "p.beta")}
    tx = jopt_mod.natural_gradient(jm, gamma=0.01, rest=optax.adam(0.02))
    grads = jax.tree_util.tree_map(lambda g: -g, g_j)
    want, _ = _jax_update(tx, jopt._trainable, grads)
    got = _port_step(topt, grads)
    for k in want:
        _close(got[k], want[k], k)


def test_nan_guard_names_the_natgrad_pairing_rule():
    """A natural-gradient run that the nan-guard aborts names the
    objective-pairing rule (tests/test_natgrad.py's probe)."""

    class Bad(thb.Model):
        def setUp(self):
            self.p = thb.Variable([2])
            self.q = thb.variationals.Gaussian(shape=[2], q_shape="diagonal")

        @thb.AutoOptimize()
        def bad(self):
            return torch.log(-torch.ones(()) - torch.sum(torch.square(self.p))) - self.KL()

    m = Bad(seed=0, device="cpu")
    opt = m.bad().compile(topt_mod.natural_gradient(m, gamma=0.1, rest=thb.adam(0.01)))
    with pytest.raises(FloatingPointError, match="pairing rule"):
        opt.optimize(maxiter=10)
