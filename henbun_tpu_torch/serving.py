"""Serving: ahead-of-time export of trained predictors as self-contained
``torch.export`` programs.

A trained model's prediction becomes an artifact with the committed
parameters and data frozen into it by value: callable without the model
object or its class. Loading needs ``torch`` and this module, which
registers K1 and K2 as the custom ops the programs call
(``ops/library.py``); the model families (``henbun_tpu_torch.models``) are
never imported.

* :func:`export_predictor`: a deterministic function of the model
  (``predict_f``, the Laplace or EP marginals, class probabilities ...)
  becomes ``artifact(x_new, ...)``.
* :func:`export_sampler`: a stochastic function (posterior draws) becomes
  ``artifact(seed, x_new, ...) -> [num, ...]``, the draw loop vmapped
  inside the program. Its noise is drawn inside the program from ``seed``
  by a counter-based generator (``core/counter.py``): the same seed gives
  the same draws bit for bit on one platform. The stream is not JAX's
  threefry.
* ``batch_polymorphic=True`` makes the leading axis of every array
  argument one shared symbolic dimension, so one artifact serves any
  request size from 1 point up: a batched solve's width is decided inside
  K2's op at run time, so a request past 128 points goes to torch.linalg
  without a guard failure.

An artifact holds one program per platform in ``platforms`` (default
``("cpu", "cuda")``, the twin of the JAX package's ``("cpu", "tpu")``),
each exported from a copy of the state on that platform's device, so no
device is baked into another's graph. A call runs the program whose device
matches its tensor arguments; numpy arguments run on the card where the
artifact holds a CUDA program and torch finds a card, else on the first
platform.
``save`` writes one zip of one ``torch.export.save`` file per platform;
a platform's program is deserialized at its first call, so a file with a
CUDA program loads and serves on a CPU-only host.
"""
from __future__ import annotations

import io
import json
import pathlib
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from .core import context as _ctx
from .core import counter as _counter
from .model import _resolve_method
from .ops import library as _library  # noqa: F401  registers the custom ops

__all__ = [
    "ServingArtifact",
    "export_predictor",
    "export_sampler",
    "load",
    "deserialize",
]

_DEFAULT_PLATFORMS = ("cpu", "cuda")


class Spec(NamedTuple):
    """One argument or output: its shape (a symbolic dimension by name)
    and dtype."""

    shape: tuple
    dtype: torch.dtype


def _specs(nodes):
    out = []
    for node in nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            shape = tuple(d if isinstance(d, int) else str(d) for d in val.shape)
            out.append(Spec(shape, val.dtype))
    return tuple(out)


class ServingArtifact:
    """Exported programs, one per platform: call it like a function,
    ``save`` it to disk or ``serialize()`` it to bytes."""

    def __init__(self, programs):
        # {platform: ExportedProgram or its serialized bytes}
        self._programs = dict(programs)
        self._modules = {}
        self._in_specs = {}

    def _program(self, platform):
        if platform not in self._programs:
            raise ValueError("this artifact holds %s, not %r" % (self.platforms, platform))
        ep = self._programs[platform]
        if isinstance(ep, bytes):
            ep = self._programs[platform] = torch.export.load(io.BytesIO(ep))
        return ep

    def _platform(self, args):
        """The device of the first array tensor among `args`; with none
        (numpy arguments, a scalar seed), the card where the artifact holds
        a CUDA program and torch finds one, else the first platform."""
        for a in args:
            if isinstance(a, torch.Tensor) and a.ndim:
                return a.device.type
        if "cuda" in self._programs and torch.cuda.is_available():
            return "cuda"
        return self.platforms[0]

    def __call__(self, *args):
        platform = self._platform(args)
        if platform not in self._modules:
            self._modules[platform] = self._program(platform).module()
            self._in_specs[platform] = self.in_specs_of(platform)
        specs = self._in_specs[platform]
        dev = torch.device(platform)
        args = tuple(
            a.to(dev) if isinstance(a, torch.Tensor) and not a.ndim
            else a if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a), dtype=s.dtype, device=dev)
            for a, s in zip(args, specs)
        )
        return self._modules[platform](*args)

    # ------------------------------------------------------------ persistence
    def serialize(self) -> bytes:
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("platforms.json", json.dumps(list(self.platforms)))
            for platform, ep in self._programs.items():
                if not isinstance(ep, bytes):
                    one = io.BytesIO()
                    torch.export.save(ep, one)
                    ep = one.getvalue()
                zf.writestr(platform + ".pt2", ep)
        return buf.getvalue()

    def save(self, path) -> None:
        pathlib.Path(path).write_bytes(self.serialize())

    # ---------------------------------------------------------- introspection
    @property
    def platforms(self):
        return tuple(self._programs)

    def in_specs_of(self, platform):
        ep = self._program(platform)
        names = set(ep.graph_signature.user_inputs)
        return _specs(n for n in ep.graph.nodes if n.op == "placeholder" and n.name in names)

    @property
    def in_specs(self):
        return self.in_specs_of(self.platforms[0])

    @property
    def out_specs(self):
        ep = self._program(self.platforms[0])
        (out,) = [n for n in ep.graph.nodes if n.op == "output"]
        names = set(ep.graph_signature.user_outputs)
        return _specs(a for a in out.args[0] if a.name in names)

    in_avals, out_avals = in_specs, out_specs  # the JAX package's names

    def __repr__(self):
        return "ServingArtifact(platforms=%r, in=%s, out=%s)" % (
            list(self.platforms), list(self.in_specs), list(self.out_specs))


def load(path) -> ServingArtifact:
    """Load an artifact saved by :meth:`ServingArtifact.save`."""
    return deserialize(pathlib.Path(path).read_bytes())


def deserialize(blob: bytes) -> ServingArtifact:
    with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
        platforms = json.loads(zf.read("platforms.json"))
        return ServingArtifact({p: zf.read(p + ".pt2") for p in platforms})


# --------------------------------------------------------------------- export
def _frozen_state(model, device):
    """Committed parameters and data by value, on `device`: they become
    the program's constants, which makes it self-contained."""
    model.initialize()
    params = {k: v.detach().to(device) for k, v in model.param_dict().items()}
    data = {k: v.detach().to(device) for k, v in model._gather_data().items()}
    return params, data


class _Program(torch.nn.Module):
    """The traced function: the model's method under a trace context over
    the frozen state (registered as buffers, so they serialize with the
    program), its noise from the counter-based stream. With `num`, the
    first argument is the seed and `num` draws are vmapped."""

    def __init__(self, model, method, params, data, device, num=None):
        super().__init__()
        self._model, self._method, self._num = model, method, num
        self._device = device
        self._params, self._data = list(params), list(data)
        for i, v in enumerate(params.values()):
            self.register_buffer("p%d" % i, v)
        for i, v in enumerate(data.values()):
            self.register_buffer("d%d" % i, v)

    def _eval(self, k, args):
        params = {p: getattr(self, "p%d" % i) for i, p in enumerate(self._params)}
        data = {p: getattr(self, "d%d" % i) for i, p in enumerate(self._data)}
        with _ctx.trace(self._model, params, data, None, noise=_counter.CounterNoise(k),
                        training=False):
            return self._method(self._model, *args)

    def forward(self, *args):
        if self._num is None:
            zero = torch.zeros((), dtype=torch.int64, device=self._device)
            return self._eval(_counter.key(zero), args)
        seed, args = args[0], args[1:]
        draws = torch.arange(self._num, dtype=torch.int64, device=seed.device)
        return torch.func.vmap(lambda d: self._eval(_counter.key(seed, d), args))(draws)


def _export(model, fn, example_args, platforms, batch_polymorphic, num=None):
    method = _resolve_method(model, fn)
    platforms = tuple(platforms)
    b = torch.export.Dim("b", min=1)
    programs = {}
    for platform in platforms:
        device = torch.device(platform)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "serving: platform 'cuda' asked for, but torch finds no CUDA device; "
                "pass platforms=('cpu',)")
        params, data = _frozen_state(model, device)
        args = tuple(torch.as_tensor(np.asarray(a), device=device) for a in example_args)
        dims = tuple({0: b} if (batch_polymorphic and a.ndim) else None for a in args)
        if num is not None:
            args = (torch.zeros((), dtype=torch.int64, device=device),) + args
            dims = (None,) + dims
        with torch.no_grad():
            programs[platform] = torch.export.export(
                _Program(model, method, params, data, device, num), args,
                dynamic_shapes=(dims,) if batch_polymorphic else None)
    return ServingArtifact(programs)


def export_predictor(model, fn, *example_args, platforms=_DEFAULT_PLATFORMS,
                     batch_polymorphic=False):
    """Export a deterministic model function as a serving artifact.

    ``fn`` is a model method in any of the usual shapes (bound method,
    unbound function, method-name string, @AutoOptimize objective); it is
    traced once per platform with the CURRENT committed parameters and
    data frozen in by value. Any reparameterization noise drawn inside is
    pinned (the counter stream at seed 0); use :func:`export_sampler` for
    genuinely stochastic outputs.

    >>> art = serving.export_predictor(m, GPRMarginal.predict_f, grid)
    >>> art.save("gpr.pt2z")                  # later, anywhere:
    >>> mean, var = serving.load("gpr.pt2z")(grid2)
    """
    return _export(model, fn, example_args, platforms, batch_polymorphic)


def export_sampler(model, fn, num, *example_args, platforms=_DEFAULT_PLATFORMS,
                   batch_polymorphic=False):
    """Export a stochastic model function as ``artifact(seed, *args)``
    returning ``num`` posterior draws stacked on the leading axis.

    The draw loop is vmapped INSIDE the program (one call for all draws,
    like :meth:`Model.draws`); ``seed`` is an integer (a 0-d int64 tensor
    or a Python or numpy int) from which the program draws its noise.
    """
    return _export(model, fn, example_args, platforms, batch_polymorphic, num=int(num))
