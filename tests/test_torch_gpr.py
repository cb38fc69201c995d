"""henbun_tpu_torch GPR against the JAX package on the CPU.

The same data (numpy seed), the same weights (the JAX model's
``param_dict()`` carried over by ``interop.params_from_jax``) and the same
noise (each node's ``u`` drawn from JAX's own keys, including the
per-model ``jax.random.split(key, M)`` of a fleet, and injected into the
port through the trace context) go through both packages. Small sizes:
n = 6 points, fleets of M = 3. The 6 points lie 1.2 lengthscales apart,
which keeps the grams conditioned well enough for float32 gradients of
any two implementations to agree to 1e-4; at 8 points on the same
interval one fleet member's lengthscale gradient already differs by a
few 1e-4 between float32 Cholesky implementations (XLA, torch.linalg,
the plain K1), each about that far from float64 too.
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from henbun_tpu import models as jmodels
from henbun_tpu.batched import BatchedOptimizer as JaxBatched
import henbun_tpu_torch as thb
from henbun_tpu_torch.interop import params_from_jax

N = 6
M = 3


def _u(key, path="q", n=N):
    """The noise the JAX package draws for the node at `path` under `key`
    (core/context.py node_key)."""
    k = jax.random.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
    return np.asarray(jax.random.normal(k, (n,), dtype=jnp.float32))


def _fleet_u(key):
    keys = jax.random.split(key, M)
    return np.stack([_u(keys[i]) for i in range(M)])


def _data(i):
    X, Y = jmodels.make_sine_dataset(n=N, seed=i)
    return X, Y


def _jax_single(objective):
    X, Y = _data(0)
    jm = jmodels.GPR(seed=0, X=X, Y=Y)
    jopt = getattr(jm, objective)().compile(optax.adam(0.01))
    tm = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = getattr(tm, objective)().compile(learning_rate=0.01)
    return jopt, topt


def _jax_fleet():
    jms, tms = [], []
    for i in range(M):
        X, Y = _data(i)
        jms.append(jmodels.GPR(seed=i, X=X, Y=Y))
        tms.append(thb.models.GPR(seed=i, X=X, Y=Y, device="cpu"))
    jopt = JaxBatched(jms, "ELBO_gaussian").compile(optax.adam(0.01))
    for tm, p in zip(tms, params_from_jax(jopt._trainable, stacked=True)):
        tm.set_param_dict(p)
    topt = thb.BatchedOptimizer(tms, "ELBO_gaussian").compile(learning_rate=0.01)
    return jopt, topt


def _jax_value_and_grad(jopt, key):
    data = jopt._data_args()
    return jax.value_and_grad(
        lambda t: jopt._evaluate(t, jopt._frozen, data, None, key)
    )(jopt._trainable)


def _port_value_and_grad(topt, noise):
    for t in topt._trainable.values():
        t.grad = None
    val, _ = topt._evaluate_core_aux(
        topt._trainable, topt._frozen, topt._data_args(), topt.model.generator, noise
    )
    val.backward()
    return val.item(), {k: t.grad.numpy() for k, t in topt._trainable.items()}


def _assert_grads(g_port, g_jax):
    """rtol 1e-4 on every leaf, atol 1e-4 of the leaf's largest entry
    (float32 Cholesky, solves and sums taken in another order)."""
    assert set(g_port) == set(g_jax)
    for k, want in g_jax.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            g_port[k], want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-6),
            err_msg=k,
        )


@pytest.mark.parametrize("objective", ["ELBO_gaussian", "ELBO_student", "ELBO_analytic"])
def test_single_model_value_and_grad_match_jax(objective):
    jopt, topt = _jax_single(objective)
    key = jax.random.PRNGKey(42)
    val_j, g_j = _jax_value_and_grad(jopt, key)
    val_t, g_t = _port_value_and_grad(topt, {"q": torch.tensor(_u(key))})
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4)
    _assert_grads(g_t, g_j)


def test_fleet_value_and_grad_match_jax():
    """The 3-model fleet under torch.func.vmap: the summed ELBO and every
    model's gradients, with each model's noise from JAX's split keys."""
    jopt, topt = _jax_fleet()
    key = jax.random.PRNGKey(7)
    val_j, g_j = _jax_value_and_grad(jopt, key)
    val_t, g_t = _port_value_and_grad(topt, {"q": torch.tensor(_fleet_u(key))})
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-4)
    _assert_grads(g_t, g_j)


@pytest.mark.parametrize("fleet", [False, True])
def test_five_adam_steps_match_optax(fleet):
    """Five torch.optim.Adam steps through Optimizer.optimize against five
    optax.adam(0.01) steps on JAX's _evaluate, same noise per step:
    objectives rtol 1e-4, parameters rtol 1e-4 / atol 1e-5."""
    jopt, topt = _jax_fleet() if fleet else _jax_single("ELBO_gaussian")
    keys = [jax.random.PRNGKey(100 + s) for s in range(5)]
    noise = [_fleet_u(k) if fleet else _u(k) for k in keys]

    tx = optax.adam(0.01)
    t, state, objs_j = jopt._trainable, None, []
    state = tx.init(t)
    data = jopt._data_args()
    for k in keys:
        val, g = jax.value_and_grad(
            lambda tt: -jopt._evaluate(tt, jopt._frozen, data, None, k)
        )(t)
        upd, state = tx.update(g, state, t)
        t = optax.apply_updates(t, upd)
        objs_j.append(-float(val))

    topt.noise_source = lambda step: {"q": torch.tensor(noise[step])}
    topt.optimize(maxiter=5)
    np.testing.assert_allclose(topt.history[-1], objs_j, rtol=1e-4)
    for k, want in t.items():
        np.testing.assert_allclose(
            topt._trainable[k].detach().numpy(), np.asarray(want),
            rtol=1e-4, atol=1e-5, err_msg=k,
        )
    # written back into the trees
    tree = topt.models if fleet else [topt.model]
    got = np.stack([m.param_dict()["k_var"].numpy() for m in tree])
    np.testing.assert_allclose(got.reshape(-1), np.asarray(t["k_var"]).reshape(-1),
                               rtol=1e-4, atol=1e-5)


def test_host_init_matches_jax_for_the_same_seed():
    """The two packages' host init RNGs draw the same initial values for
    the same seed and construction order (exact)."""
    import henbun_tpu as jhb

    X, Y = _data(0)
    jhb.set_seed(3)
    jm = jmodels.GPR(seed=0, X=X, Y=Y)
    thb.set_seed(3)
    tm = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
    jm.initialize()
    tm.initialize()
    jp, tp = jm.param_dict(), tm.param_dict()
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
