"""Profiling and observability.

When ``[profiling] dump_timeline`` or ``dump_tensorboard`` is set,
``Optimizer.optimize`` runs inside a ``torch.profiler`` trace (CPU, and
CUDA when there is a card) whose Chrome trace lands in
``[profiling] profile_dir``; otherwise the wrapper does nothing.
``StepMetrics`` records per-chunk objective and step rate.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .._settings import settings


def profile_dir():
    d = settings.profiling.profile_dir
    os.makedirs(d, exist_ok=True)
    return d


@contextlib.contextmanager
def trace_if_enabled(name="henbun"):
    """Wrap a block in a torch.profiler trace when [profiling]
    dump_timeline or dump_tensorboard is set; a no-op otherwise."""
    enabled = bool(settings.profiling.dump_timeline) or bool(
        settings.profiling.dump_tensorboard
    )
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(
        profile_dir(), "%s-%d-%d.json" % (name, os.getpid(), time.time_ns())
    )
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(path)


def annotate(name):
    """Named range visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepMetrics:
    """Lightweight training metrics per chunk: objective and steps/s,
    printed under [verbosity] optimisation_verb."""

    def __init__(self, log_every=1):
        self.log_every = log_every
        self.rows = []

    def record(self, step, objective, seconds, n_steps, extra=None):
        row = {
            "step": int(step),
            "objective": float(np.asarray(objective).reshape(-1)[-1]),
            "steps_per_s": float(n_steps / seconds) if seconds > 0 else float("inf"),
        }
        if extra:
            row.update(extra)
        self.rows.append(row)
        if settings.verbosity.optimisation_verb:
            if len(self.rows) % self.log_every == 0:
                print(
                    "[henbun] step %(step)d  objective %(objective).6g  "
                    "%(steps_per_s).1f steps/s" % row
                )
        return row
