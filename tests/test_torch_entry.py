"""henbun_tpu_torch.entry, the port's twin of ``__graft_entry__.py``, on the
CPU: ``entry()``'s ELBO against the JAX package's at the same weights and
the same draws (rtol 1e-5), and ``dryrun_multichip(2)`` running its six
mechanisms on two gloo ranks (processes of the module), with a failing
rank raising, and the entry points raising without a card unless told
"cpu"."""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from henbun_tpu_torch import entry
from henbun_tpu_torch.interop import params_from_jax

MECHANISMS = ("svi", "fleet", "log_marginal_laplace", "log_marginal_ep", "chees", "smc")


def test_entry_matches_the_jax_entry():
    """fn(params, noise) at the JAX model's weights with its draw for the
    local node "z" injected: the JAX entry's fn(params, key)."""
    import __graft_entry__ as graft

    jfn, (jparams, key) = graft.entry()
    want = float(jax.jit(jfn)(jparams, key))
    fn, (params, noise) = entry.entry(device="cpu")
    assert noise is None and set(params) == set(jparams)
    k = jax.random.fold_in(key, zlib.crc32(b"z") & 0x7FFFFFFF)
    u = torch.tensor(np.asarray(jax.random.normal(k, (256, 2), dtype=jnp.float32)))
    got = fn(params_from_jax(jparams), {"z": u})
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert np.isfinite(float(fn(params)))  # the draw taken from the model's generator


def test_dryrun_multichip_two_ranks_on_the_cpu():
    """Six mechanisms on two gloo ranks, the mesh split as the JAX
    package's (n_chain = 2, n_data = 1 at n = 2): every one finishes
    finite, and the replicated results agree across the ranks."""
    out = entry.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    for o in out:
        assert o["backend"] == "gloo" and o["device"] == "cpu"
        assert set(MECHANISMS) <= set(o)
        assert o["log_marginal_laplace"]["rows"] == [0, 32]
    for k in MECHANISMS:
        assert out[0][k] == out[1][k], k


def test_dryrun_multichip_raises_when_a_rank_fails():
    """Ranks asked for a card that is not there fail; so does the call."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the ranks would not fail")
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
        entry.dryrun_multichip(2, device="cuda")


def test_entry_and_dryrun_without_a_card_raise_unless_told_cpu():
    """With no card and no device, entry() and dryrun_multichip(1) take
    the [cuda] device setting's CUDA and raise the RuntimeError a Model
    raises (before any rank starts); with the setting at cpu, entry()
    runs on the CPU."""
    import henbun_tpu_torch as thb

    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is there to take")
    for call in (entry.entry, lambda: entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg = thb.settings.get_settings()
    cfg.cuda.device = "cpu"
    with thb.settings.temp_settings(cfg):
        fn, (params, _) = entry.entry()
    assert next(iter(params.values())).device.type == "cpu"
    assert np.isfinite(float(fn(params)))
