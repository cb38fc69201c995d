"""Name scoping.

``NameScoped`` wraps a function in ``torch.profiler.record_function``, so
the scope name shows up as a range in profiler traces (the JAX package
uses ``jax.named_scope`` for the same role). ``Parameterized.scoped_keys``
methods get this automatically inside an objective's evaluation while the
profiler is on (``core/param.py``).
"""
from __future__ import annotations

import functools

import torch


class NameScoped:
    def __init__(self, name):
        self.name = name

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(self.name):
                return fn(*args, **kwargs)

        return wrapped
