"""The control and the planted faults that ``correct`` has to catch, each
a context manager over the program under test. The benchmark's own runs
use none of them: ``calibrate.py`` reads them on the card, and
``tests/test_portbench_faults.py`` sees ``correct`` come out false under
each on the CPU.

* ``tf32``: the control, the program's own lower-precision path: float32
  products in TF32 (``[cuda] matmul_precision = high``), the step below the
  ``highest`` the configurations state.
* ``tf32_reference``: the control where the program's TF32 does not reach
  the arithmetic (a fleet's small batched products, K1 and K2): the
  reference itself in the program's place, in float32 with every product's
  operands rounded to TF32 (``reference/common.py``). ``drivers/fit.py``
  computes it in ``readings(control="tf32_reference")``; planting it changes
  nothing in the program.
* ``frozen_state``: every optimization step computes its update and then
  leaves the parameters as they were.
* ``half_batch``: the objective is taken over the first half of the batch
  (a fleet's models, one model's rows) and scaled up to the whole, the
  mean of the rest standing for it.
* ``answer_altered``: a served call's first mean is moved by 0.1 where the
  program produces it.

One card, no exchange between chips: that fault has no cell here.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("tf32", "tf32_reference", "frozen_state", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


@contextlib.contextmanager
def tf32():
    import henbun_tpu_torch as hb
    from henbun_tpu_torch._settings import apply_matmul_precision

    before = hb.settings.cuda.matmul_precision
    hb.settings.cuda.matmul_precision = "high"
    try:
        yield
    finally:
        hb.settings.cuda.matmul_precision = before
        apply_matmul_precision()


def tf32_reference():
    return contextlib.nullcontext()


def frozen_state():
    from henbun_tpu_torch.model import Optimizer

    def make(orig):
        def step(self, d, noise):
            keep = {k: v.detach().clone() for k, v in self._trainable.items()}
            out = orig(self, d, noise)
            with torch.no_grad():
                for k, v in keep.items():
                    self._trainable[k].copy_(v)
            return out
        return step

    return _patched(Optimizer, "_step", make)


def _half(core, batched):
    def half(trainable, frozen, d, generator, noise):
        if batched:
            full = next(iter(trainable.values())).shape[0]
            h = full // 2
            cut = lambda dd: {k: v[:h] for k, v in (dd or {}).items()}  # noqa: E731
            val, diags = core(cut(trainable), cut(frozen), cut(d), generator,
                              cut(noise) if noise else noise)
        else:
            full = next(iter(d.values())).shape[0]
            h = full // 2
            val, diags = core(trainable, frozen, {k: v[:h] for k, v in d.items()},
                              generator, noise)
        return val * (full / h), diags
    return half


def half_batch():
    from henbun_tpu_torch.batched import BatchedOptimizer
    from henbun_tpu_torch.model import Optimizer

    def make(orig):
        def compile(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            self._evaluate_core_aux = _half(self._evaluate_core_aux,
                                            isinstance(self, BatchedOptimizer))
            return out
        return compile

    return _patched(Optimizer, "compile", make)


def answer_altered():
    from henbun_tpu_torch.serving import ServingArtifact

    def make(orig):
        def call(self, *args):
            mean, var = orig(self, *args)
            mean = mean.clone()
            mean[0] += 0.1
            return mean, var
        return call

    return _patched(ServingArtifact, "__call__", make)


def planted(name):
    """The context manager of the control or fault `name`."""
    if name not in NAMES:
        raise KeyError("no fault named %r (%s)" % (name, ", ".join(NAMES)))
    return globals()[name]()
