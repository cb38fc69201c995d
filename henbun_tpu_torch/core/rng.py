"""Host-side RNG used for parameter initialization.

Initialization happens on the host with numpy; ``set_seed`` makes it
reproducible. The same draws as the JAX package's host RNG for the same
seed, so two trees built after ``set_seed(s)`` start from the same values.

Device-side randomness (reparameterization noise, minibatch indices) never
touches this module: it flows through the explicit ``torch.Generator`` that
the trace context carries.
"""
from __future__ import annotations

import numpy as np

_rng = np.random.default_rng(0)


def set_seed(seed):
    """Reset the host init RNG (and return it)."""
    global _rng
    _rng = np.random.default_rng(seed)
    return _rng


def get_rng():
    return _rng


def truncated_normal(shape, mean=0.0, stddev=1.0, dtype=np.float32):
    """Normal(mean, stddev) with draws beyond 2 stddev re-drawn (then
    clipped), the truncated-normal initializer."""
    shape = tuple(int(s) for s in shape)
    out = _rng.standard_normal(shape)
    for _ in range(8):
        bad = np.abs(out) > 2.0
        if not bad.any():
            break
        out[bad] = _rng.standard_normal(int(bad.sum()))
    out = np.clip(out, -2.0, 2.0)
    return (mean + stddev * out).astype(dtype)
