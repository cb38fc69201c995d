"""henbun_tpu_torch's GPRMarginal against the JAX package's on the CPU.

The same data (sorted U[0, 6] inputs, y = sin(x) + 0.3 N(0, 1), numpy
seeds) and the same weights (the JAX model's ``param_dict()`` carried over
by ``interop.params_from_jax``) go through both packages: the exact
evidence ``log_marginal`` with its gradients at n = 40 and 256,
``predict_f``, and three Adam steps against optax. The gram is one 2-D
matrix, so both packages factor it with their linear-algebra library
(XLA, torch.linalg) and differentiate it through their Murray backward.
"""
import numpy as np
import jax
import optax
import pytest

from henbun_tpu import models as jmodels
import henbun_tpu_torch as thb
from henbun_tpu_torch.interop import params_from_jax


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    Y = (np.sin(X) + 0.3 * rng.standard_normal(X.shape)).astype(np.float32)
    return X, Y


def _pair(n, seed=0):
    """(JAX optimizer, port optimizer) on the same data and weights."""
    X, Y = _data(n, seed)
    jm = jmodels.GPRMarginal(seed=seed, X=X, Y=Y)
    jopt = jm.log_marginal().compile(optax.adam(0.01))
    tm = thb.models.GPRMarginal(seed=seed, X=X, Y=Y, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    return jopt, tm.log_marginal().compile(learning_rate=0.01)


def _jax_value_and_grad(jopt):
    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda t, fr, d: jax.value_and_grad(
        lambda tt: jopt._evaluate(tt, fr, d, None, key))(t))
    frozen, data = jopt._frozen, jopt._data_args()
    return lambda t: fn(t, frozen, data)


@pytest.mark.parametrize("n", [40, 256])
def test_log_marginal_value_and_grad_match_jax(n):
    """The evidence rtol 1e-4; each gradient leaf rtol 1e-4, atol 1e-4 of
    its largest entry (float32 factorizations and solves in another
    order)."""
    jopt, topt = _pair(n, seed=n)
    val_j, g_j = _jax_value_and_grad(jopt)(jopt._trainable)
    val_t, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, topt._data_args(),
                                       topt.model.generator, None)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    assert set(g_j) == set(topt._trainable) == {"kern.lengthscales", "k_var", "var"}
    for k, want in g_j.items():
        want = np.asarray(want)
        np.testing.assert_allclose(topt._trainable[k].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_predict_f_matches_jax():
    """Posterior mean and variance at 9 new points, inside and beyond the
    data: rtol 1e-4, atol 1e-6."""
    jopt, topt = _pair(40, seed=3)
    jm, tm = jopt.model, topt.model
    grid = np.linspace(-1, 7, 9, dtype=np.float32)[:, None]
    want = jax.jit(lambda g: jm.run(lambda mm: mm.predict_f(g)))(grid)
    got = tm.run(lambda mm: mm.predict_f(grid))
    for name, g, w in zip(("mean", "var"), got, want):
        assert g.shape == (9, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert (got[1] >= 0).all()


def test_three_adam_steps_match_optax():
    """Three torch.optim.Adam steps through Optimizer.optimize against three
    optax.adam(0.01) steps on JAX's objective: objectives rtol 1e-4,
    parameters rtol 1e-4 / atol 1e-5."""
    jopt, topt = _pair(40, seed=1)
    vg = _jax_value_and_grad(jopt)
    tx = optax.adam(0.01)
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
