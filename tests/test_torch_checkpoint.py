"""Checkpoints of henbun_tpu_torch on the CPU.

* Parameter checkpoints (``Parameterized.save`` / ``restore``,
  ``utils/checkpoint.py``) are the JAX package's ``.npz`` of free-space
  values keyed by ``long_name``: a file written by either package restores
  in the other with equal free values, for a ``SparseGPC`` (its frozen
  ``gp.z`` included) and a ``GPR`` with a fullrank q.
* Training-state checkpoints (``Optimizer.save_state`` /
  ``restore_state``) are port-only ``torch.save`` files: a run of 2k steps
  equals k steps, a save, a restore into a fresh model and optimizer, and
  k more steps, bit for bit, with Adam on a Monte Carlo ELBO (the
  generator's state) and with the natural gradient (its ``rest`` state
  and adaptive scales); a staged assignment reaches the saved state, and
  one pending at restore time does not clobber the restored values.
"""
import numpy as np
import pytest
import torch

from henbun_tpu import models as jmodels
import henbun_tpu_torch as thb
from henbun_tpu_torch import optimizers as topt_mod
from henbun_tpu_torch.core.param import _to_numpy
from henbun_tpu_torch.utils import checkpoint


def _data(kind):
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(0, 6, (30, 1))).astype(np.float32)
    if kind == "sparse_gpc":
        Y = (rng.uniform(size=X.shape) < 1 / (1 + np.exp(-3 * np.sin(X)))).astype(np.float32)
    else:
        Y = (np.sin(X) + 0.3 * rng.standard_normal(X.shape)).astype(np.float32)
    return X, Y


def _models(kind, seed):
    X, Y = _data(kind)
    if kind == "sparse_gpc":
        return (jmodels.SparseGPC(seed=seed, X=X, Y=Y, num_inducing=6),
                thb.models.SparseGPC(seed=seed, X=X, Y=Y, num_inducing=6, device="cpu"))
    return (jmodels.GPR(seed=seed, X=X, Y=Y, q_shape="fullrank"),
            thb.models.GPR(seed=seed, X=X, Y=Y, q_shape="fullrank", device="cpu"))


def _free(model):
    return {v.long_name: np.asarray(_to_numpy(v.free_value))
            for v in checkpoint._global_vars(model)}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["sparse_gpc", "gpr_fullrank"])
def test_npz_checkpoint_restores_across_packages(tmp_path, kind, direction):
    """The reader's weights are moved off the writer's first; after the
    restore its free values equal the writer's exactly, key for key
    (global_step suffixes the written name)."""
    jm, tm = _models(kind, seed=0)
    jm.initialize()
    tm.initialize()
    writer, reader = (jm, tm) if direction == "jax_to_port" else (tm, jm)
    for v in checkpoint._global_vars(reader):
        v.set_free_value(np.asarray(_to_numpy(v.free_value)) + np.float32(0.5))
    before = {k: v.copy() for k, v in _free(reader).items()}
    path = writer.save(str(tmp_path / "m.ckpt"), global_step=7)
    assert path.endswith("m.ckpt-7")
    reader.restore(path)
    want = dict(np.load(path))
    got = _free(reader)
    assert set(got) == set(want) == set(before)
    assert all(not np.array_equal(before[k], want[k]) for k in want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    if kind == "sparse_gpc":
        assert "model.gp.z" in want


def test_restore_survives_initialize_and_subtree_save(tmp_path):
    """A restore clears the staged-assignment flags, so a later
    initialize() keeps the restored values; a subtree saves and restores
    on its own, keyed by its long names."""
    _, tm = _models("gpr_fullrank", seed=0)
    tm.initialize()
    val = tm.k_var.value.copy()
    path = tm.save(str(tmp_path / "m.ckpt"))
    tm.k_var = np.asarray([5.0], np.float32)
    tm.initialize()
    assert not np.allclose(tm.k_var.value, val)
    tm.restore(path)
    tm.initialize()
    np.testing.assert_array_equal(tm.k_var.value, val)
    kern_path = tm.kern.save(str(tmp_path / "kern.ckpt"))
    assert set(np.load(kern_path)) == {"model.kern.lengthscales"}
    ls = tm.kern.lengthscales.value.copy()
    tm.kern.lengthscales = np.asarray([3.0], np.float32)
    tm.kern.restore(kern_path)
    np.testing.assert_array_equal(tm.kern.lengthscales.value, ls)


# ------------------------------------------------------------ training state
def _fresh(kind):
    thb.set_seed(0)
    X, Y = thb.models.make_sine_dataset(n=12)
    if kind == "adam_mc":
        m = thb.models.GPR(seed=0, X=X, Y=Y, device="cpu")
        return m, m.ELBO_gaussian().compile(thb.adam(0.01))
    m = thb.models.GPR(seed=0, X=X, Y=Y, q_shape="diagonal", device="cpu")
    return m, m.ELBO_gaussian().compile(
        topt_mod.natural_gradient(m, gamma=0.01, rest=thb.adam(0.02), adaptive=True))


def _final(m):
    return {k: v.numpy() for k, v in m.param_dict().items()}


@pytest.mark.parametrize("kind", ["adam_mc", "natgrad"])
def test_save_state_resume_is_exact(tmp_path, kind):
    """2k steps in one run == k steps, save_state, restore_state into a
    fresh model and optimizer, k steps (every parameter bit for bit, the
    step counter and the objective history's second half too)."""
    k = 30
    m0, o0 = _fresh(kind)
    o0.optimize(maxiter=2 * k)
    path = str(tmp_path / "state.pt")
    m1, o1 = _fresh(kind)
    o1.optimize(maxiter=k)
    o1.save_state(path)
    m2, o2 = _fresh(kind)
    o2.restore_state(path)
    assert o2.global_step == k
    o2.optimize(maxiter=k)
    assert o2.global_step == 2 * k
    want = _final(m0)
    assert set(_final(m2)) == set(want)
    for key, v in _final(m2).items():
        assert np.array_equal(v, want[key]), key
    np.testing.assert_array_equal(np.concatenate(o2.history), np.concatenate(o0.history)[k:])
    if kind == "natgrad":
        scales = o2.torch_optimizer.state_dict()["gamma_scale"]
        assert scales and all(torch.equal(v, o0.torch_optimizer.state["gamma_scale"][p])
                              for p, v in scales.items())


def test_staged_assignment_reaches_the_saved_state(tmp_path):
    """test_checkpoint.py's contract: an assignment staged after the last
    run is in the checkpoint, and one pending at restore time does not
    clobber the restored values afterwards."""
    m, opt = _fresh("adam_mc")
    m.var = np.asarray([0.5], np.float32)  # staged, no run() since
    path = str(tmp_path / "staged.pt")
    opt.save_state(path)
    assert abs(float(m.var.value[0]) - 0.5) < 1e-6

    m2, o2 = _fresh("adam_mc")
    m2.var = np.asarray([9.0], np.float32)  # pending at restore time
    o2.restore_state(path)
    o2.run()  # refreshes pending assignments: must not re-apply the 9.0
    assert abs(float(m2.var.value[0]) - 0.5) < 1e-6
    assert abs(o2._trainable["var"].item() - thb.transforms.positive.backward(np.float32(0.5))) < 1e-6
