"""Carry weights over from the JAX package.

The two packages key free-space parameters by the same dotted tree paths
(``long_name`` relative to the model), so a ``param_dict()`` of a
``henbun_tpu`` model — arrays of any kind that ``numpy.asarray`` reads —
becomes this package's dict for ``set_param_dict``. Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(param_dict, stacked=False, device=None):
    """{path: free-space tensor} from the JAX package's
    ``Model.param_dict()`` (or a BatchedOptimizer's stacked trainable /
    frozen dicts with ``stacked=True``: then a list of per-model dicts, one
    per index of the leading axis)."""
    host = {k: np.asarray(v) for k, v in param_dict.items()}
    if not stacked:
        return {k: torch.tensor(v, device=device) for k, v in host.items()}
    sizes = {v.shape[0] for v in host.values()}
    if len(sizes) != 1:
        raise ValueError("stacked dicts need one leading size, got %r" % sorted(sizes))
    return [
        {k: torch.tensor(v[i], device=device) for k, v in host.items()}
        for i in range(sizes.pop())
    ]
