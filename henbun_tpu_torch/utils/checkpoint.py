"""Checkpointing: subtree-granular save/restore keyed by tree paths.

A checkpoint holds a subtree's global parameters only, as a plain ``.npz``
of free-space host arrays keyed by ``long_name``, with ``global_step``
suffixing the file name. That is the JAX package's format, so a
checkpoint written by either package restores in the other.

The JAX package's ``save_orbax`` / ``restore_orbax`` have no counterpart
here: orbax is a JAX library. The full training state of an Optimizer
(parameters, optimizer state, step, generator) is
``Optimizer.save_state`` / ``restore_state``, a ``torch.save`` file that
only this package reads.
"""
from __future__ import annotations

import numpy as np

from ..core.param import _to_numpy, graph_key


def _global_vars(subtree):
    return [
        v
        for v in subtree.get_variables()
        if v.collections not in graph_key.not_parameters
    ]


def save(subtree, save_path=None, global_step=None):
    """Save the subtree's global parameters (free-space values) keyed by
    long_name. Returns the written path."""
    if save_path is None:
        save_path = subtree.name + ".ckpt"
    if global_step is not None:
        save_path = "%s-%d" % (save_path, int(global_step))
    variables = _global_vars(subtree)
    if len(variables) == 0:
        raise ValueError("This class does not contain any global variables.")
    subtree.highest_parent.initialize()
    arrays = {v.long_name: _to_numpy(v.free_value) for v in variables}
    with open(save_path, "wb") as f:
        np.savez(f, **arrays)
    return save_path


def restore(subtree, save_path=None):
    """Restore free-space values into the subtree, keyed by long_name; clears
    assignment flags so a later initialize() won't clobber restored
    values."""
    if save_path is None:
        save_path = subtree.name + ".ckpt"
    variables = _global_vars(subtree)
    if len(variables) == 0:
        raise ValueError("This class does not contain any global variables.")
    with np.load(save_path) as archive:
        for v in variables:
            v.set_free_value(archive[v.long_name])
    for v in subtree.get_variables():
        v.finalize()
