"""The port's amortized, BNN and linear families (and nn.py beneath them)
against the JAX package on the CPU.

The same numpy-seeded data, the same weights (``interop.params_from_jax``),
the same minibatch rows and the same noise (each Variational node's ``u``
drawn from JAX's key for its path and injected into the port). Widths are
``__graft_entry__._tiny_model``'s (d_x = 4, d_z = 2, hidden = 16) at
n = 64, minibatches of 16 rows.

Tolerances: objective rtol 1e-4; each gradient leaf within 1e-4 of its
largest entry (float32 sums and products taken in another order).
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
import henbun_tpu_torch as thb
from henbun_tpu_torch.interop import params_from_jax

ROWS = np.random.default_rng(11).choice(64, 16, replace=False)


def _node_u(key, path, shape):
    """The noise the JAX package draws for the node at `path`."""
    k = jax.random.fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)
    return torch.tensor(np.asarray(jax.random.normal(k, shape, dtype=jnp.float32)))


def _global_noise(tmodel, key):
    """Injected noise for every non-LOCAL Variational node of a port model."""
    out = {}

    def walk(node):
        if isinstance(node, thb.variationals.Variational) and node.collections != "LOCAL":
            out[node.path_to(tmodel)] = _node_u(
                key, node.path_to(tmodel), tuple(node.n_layers) + (node.size,))
        for child in getattr(node, "sorted_variables", []):
            walk(child)

    walk(tmodel)
    return out


def _pair(jcls, tcls, method, **kw):
    jm = jcls(seed=0, **kw)
    jopt = getattr(jm, method)().compile(optax.adam(0.01))
    tm = tcls(seed=0, device="cpu", **kw)
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    topt = getattr(tm, method)().compile(learning_rate=0.01)
    return jopt, topt


def _compare(jopt, topt, key, noise, rows=None):
    idx = None if rows is None else jnp.asarray(rows)
    val_j, g_j = jax.jit(jax.value_and_grad(
        lambda t, f, d, i, k: jopt._evaluate(t, f, d, i, k)))(
        jopt._trainable, jopt._frozen, jopt._data_args(), idx, key)
    data = topt._data_args()
    if rows is not None:
        data = topt._take_rows(data, torch.as_tensor(rows))
    for t in topt._trainable.values():
        t.grad = None
    val_t, _ = topt._evaluate_core_aux(topt._trainable, topt._frozen, data,
                                       topt.model.generator, noise)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    assert set(g_j) == set(topt._trainable)
    for k, want in g_j.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            topt._trainable[k].grad.numpy(), want, rtol=0,
            atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=k)


@pytest.mark.parametrize("q_local", ["diagonal", "fullrank_packed"])
def test_amortized_elbo_and_grads_match_jax(q_local):
    X, Y = jmodels.make_synthetic_regression(n=64, d_x=4, seed=0)
    tX, tY = thb.models.make_synthetic_regression(n=64, d_x=4, seed=0)
    np.testing.assert_array_equal(X, tX)
    np.testing.assert_array_equal(Y, tY)
    jopt, topt = _pair(jmodels.AmortizedRegression, thb.models.AmortizedRegression, "ELBO",
                       X=X, Y=Y, d_z=2, hidden=16, q_local=q_local)
    key = jax.random.PRNGKey(5)
    _compare(jopt, topt, key, {"z": _node_u(key, "z", (len(ROWS), 2))}, ROWS)


def test_packed_slab_conditioning_matches_jax():
    from henbun_tpu.models import _slab as jslab
    from henbun_tpu_torch.models import _slab as tslab

    for want, got in zip(jslab.packed_slab_conditioning(4, 14),
                         tslab.packed_slab_conditioning(4, 14)):
        np.testing.assert_array_equal(got, want)
    slab = np.random.default_rng(0).normal(size=(5, 14)).astype(np.float32)
    bias, scale = tslab.packed_slab_conditioning(4, 14)
    np.testing.assert_allclose(
        tslab.condition_slab(torch.tensor(slab), bias, scale).numpy(),
        np.asarray(jslab.condition_slab(jnp.asarray(slab), bias, scale)), rtol=1e-6)
    assert tslab.condition_slab(torch.tensor(slab), None, None) is not None


def test_variational_bnn_elbo_and_grads_match_jax():
    """NeuralNet with Normal weights: every weight and bias a sampled
    posterior, its noise injected per node."""
    X, Y = jmodels.make_bnn_dataset(n=24, seed=0)
    jopt, topt = _pair(jmodels.VariationalBNN, thb.models.VariationalBNN, "ELBO",
                       X=X, Y=Y, hidden=8)
    key = jax.random.PRNGKey(9)
    noise = _global_noise(topt.model, key)
    assert len(noise) == 4  # w and b of both layers
    _compare(jopt, topt, key, noise)


def test_bnn_log_posterior_matches_jax():
    X, Y = jmodels.make_bnn_dataset(n=24, seed=1)
    jopt, topt = _pair(jmodels.BNN, thb.models.BNN, "log_posterior", X=X, Y=Y, hidden=8)
    _compare(jopt, topt, jax.random.PRNGKey(0), None)


@pytest.mark.parametrize("kind", ["variational", "map"])
def test_linear_models_match_jax(kind):
    X, Y = jmodels.make_linear_dataset(n=30, seed=0)
    np.testing.assert_array_equal(Y, thb.models.make_linear_dataset(n=30, seed=0)[1])
    if kind == "variational":
        jopt, topt = _pair(jmodels.VariationalLinearModel, thb.models.VariationalLinearModel,
                           "elbo", X=X, Y=Y)
        key = jax.random.PRNGKey(2)
        _compare(jopt, topt, key, _global_noise(topt.model, key))
    else:
        jopt, topt = _pair(jmodels.MAPLinearModel, thb.models.MAPLinearModel, "logp",
                           X=X, Y=Y)
        _compare(jopt, topt, jax.random.PRNGKey(0), None)


def test_neural_net_layers_and_activations():
    """NeuralNet's layer count, per-layer activations and its forward pass
    against the JAX package's at the same weights."""
    x = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)

    class JNet(jhb.model.Model):
        def setUp(self):
            self.net = jhb.nn.NeuralNet([3, 7, 6, 2], neuron_types=[jhb.nn.relu, jhb.nn.sigmoid])

    class TNet(thb.Model):
        def setUp(self):
            self.net = thb.nn.NeuralNet([3, 7, 6, 2], neuron_types=[thb.nn.relu, thb.nn.sigmoid])

    jm, tm = JNet(seed=0), TNet(seed=0, device="cpu")
    tm.set_param_dict(params_from_jax(jm.param_dict()))
    assert sorted(tm.param_dict()) == sorted(jm.param_dict())
    want = np.asarray(jm.run(lambda mm: mm.net(jnp.asarray(x))))
    got = tm.run(lambda mm: mm.net(torch.tensor(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert thb.nn.tanh(torch.zeros(1)).item() == 0.0


def test_unfed_local_node_raises_naming_it():
    class Unfed(thb.Model):
        def setUp(self):
            self.z = thb.variationals.Normal(shape=[2], collections=thb.graph_key.LOCAL)
            self.w = thb.Variable([1])

        @thb.AutoOptimize()
        def obj(self):
            return torch.sum(self.z) + torch.sum(self.w)

    m = Unfed(seed=0, device="cpu")
    with pytest.raises(ValueError, match=r"z is not fed"):
        m.obj().compile()
