"""Trace context: the state one evaluation of a model objective sees.

A model objective is an ordinary Python method, run with a
:class:`TraceContext` active. During that run:

* global ``Variable`` leaves read their *free* value from ``ctx.params``
  and return the transformed tensor,
* ``Data`` leaves read from ``ctx.data``,
* LOCAL leaves read what an encoder fed via ``ctx.feeds``,
* ``Variational`` nodes take their reparameterization noise once per
  evaluation from :meth:`TraceContext.node_noise` and cache the sample in
  ``ctx.samples``, so that ``KL()`` sees the same noise as the sample.

Noise comes from the context's ``torch.Generator``, unless the caller hands
in ``noise={path: u}``: then the node at ``path`` takes ``u`` instead of a
draw. That hook lets a test feed the same noise to this package and to the
JAX package, whose threefry streams torch cannot reproduce.

The context is thread-local and re-entrant; nothing is stored on the model
objects, so one objective can run under ``torch.func.vmap`` over a fleet.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_STATE = threading.local()


def current():
    """The innermost active TraceContext, or None outside any trace."""
    return getattr(_STATE, "ctx", None)


class TraceContext:
    __slots__ = (
        "root",
        "params",
        "data",
        "generator",
        "noise",
        "feeds",
        "samples",
        "rng_counts",
        "training",
        "diagnostics",
        "diagnostic_guards",
    )

    def __init__(self, root, params, data, generator, noise=None,
                 training=True):
        self.root = root
        self.params = params        # {path: free-space tensor} for global Variables
        self.data = data            # {path: tensor} for Data nodes
        self.generator = generator  # torch.Generator for this evaluation's noise
        self.noise = noise or {}    # {path: injected standard-normal noise}
        self.feeds = {}             # {path: raw fed tensor} for LOCAL Variables
        self.samples = {}           # {path: dict(u=..., raw=..., transformed=...)}
        self.rng_counts = {}        # {tag: draw count} for tagged_noise
        self.training = training
        self.diagnostics = {}        # {name: scalar tensor} side-channel
        self.diagnostic_guards = {}  # {name: (tol, hint)} guard specs

    def report_diagnostic(self, name, value, guard_tol=None, hint=""):
        """Expose a scalar to the training loop.

        The Optimizer stacks reported values per step, records the latest in
        StepMetrics and, when ``guard_tol`` is given, aborts the run with
        ``hint`` in the message on a PERSISTENT violation (the chunk ends
        above tol, or more than 25% of its steps violate). Repeated reports
        under one name within an evaluation keep the elementwise maximum."""
        if name in self.diagnostics:
            value = torch.maximum(self.diagnostics[name], value)
        self.diagnostics[name] = value
        if guard_tol is not None:
            self.diagnostic_guards[name] = (float(guard_tol), str(hint))

    def node_noise(self, path, shape, dtype):
        """Standard-normal noise of ``shape`` for the node at ``path``: the
        injected tensor when the caller handed one in for that path, else a
        fresh draw from the context's generator. A ``noise`` object with a
        ``draw`` method (``core/counter.py``'s, in an exported program)
        draws every path itself, at a shape that may be symbolic."""
        draw = getattr(self.noise, "draw", None)
        if draw is not None:
            return draw(path, tuple(shape), dtype)
        shape = tuple(int(s) for s in shape)
        if path in self.noise:
            u = self.noise[path]
            if tuple(u.shape) != shape:
                raise ValueError(
                    "injected noise for %r has shape %s, the node draws %s"
                    % (path, tuple(u.shape), shape)
                )
            return u.to(dtype)
        g = self.generator
        return torch.randn(shape, generator=g, dtype=dtype, device=g.device)

    def tagged_noise(self, tag, shape, dtype):
        """Fresh noise per call for a given tag, for ops that draw several
        times in one evaluation; the n-th draw's injection path is
        ``"<tag>#<n>"``."""
        c = self.rng_counts.get(tag, 0)
        self.rng_counts[tag] = c + 1
        return self.node_noise("%s#%d" % (tag, c), shape, dtype)


@contextmanager
def trace(root, params, data, generator, noise=None, training=True):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = TraceContext(
        root, params, data, generator, noise=noise, training=training
    )
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev
