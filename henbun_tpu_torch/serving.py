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

At that first call the program's module is also folded: the part of the
graph that depends only on the frozen state (for ``GPRMarginal.predict_f``
the training gram, its factor through the masked ladder, and ``alpha``) is
evaluated once on the platform's device and kept as buffers, and every
call runs only what reads its arguments. The saved program is unchanged.
``artifact.folds`` records, per platform, the operations folded, those
left per call and the bytes kept.
"""
from __future__ import annotations

import io
import json
import operator
import pathlib
import types
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from .core import context as _ctx
from .core import counter as _counter
from .model import _resolve_method
from .ops import library as _library  # noqa: F401  registers the custom ops

__all__ = [
    "FoldRecord",
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


# ------------------------------------------------------------------- folding
class FoldRecord(NamedTuple):
    """What folding one platform's program did: `folded` operations left
    the per-call graph (evaluated once, or dead), `per_call` operations run
    in every call, and `kept_bytes` of folded values stay on the device for
    them."""

    folded: int
    per_call: int
    kept_bytes: int


_CALLS = ("call_function", "call_method", "call_module")
_NONDETERMINISTIC = {torch.Tag.nondeterministic_seeded, torch.Tag.nondeterministic_bitwise}
# pure though torch.fx calls them impure: detach_ writes autograd's record,
# not the values; a metadata check on constants holds in every call or none
_PURE = {operator.getitem, torch.ops.aten.detach_.default,
         torch.ops.aten._assert_tensor_metadata.default}


def _attr(module, target):
    for name in target.split("."):
        module = getattr(module, name)
    return module


def _nodes(value):
    found = []
    torch.fx.node.map_arg(value, found.append)
    return found


def _functorch():
    """The calls by which an exported graph enters and leaves a vmap:
    (its decompositions' loader, the level's increment, its decrement,
    all of them with the batch dimension's own)."""
    from torch._functorch import predispatch as p

    load, inc, dec, add, remove = (getattr(p, name, None) for name in (
        "lazy_load_decompositions", "_vmap_increment_nesting", "_vmap_decrement_nesting",
        "_add_batch_dim", "_remove_batch_dim"))
    return load, inc, dec, {load, inc, dec, add, remove}


def _vmap_regions(graph, load, inc, dec):
    """Each outermost vmap of `graph`: its nodes from the loader before the
    level's increment to its decrement."""
    regions, depth = [], 0
    for node in graph.nodes:
        if node.target is inc:
            if not depth:
                regions.append([node.prev] if load and node.prev.target is load else [])
            depth += 1
        if depth:
            regions[-1].append(node)
        if node.target is dec:
            depth = max(depth - 1, 0)
    return regions


def _aliases(node):
    """The input nodes whose storage `node`'s value may share, and those it
    writes into: by the operator's schema; anything else (``getitem``, a
    module) may share all its inputs, and writes them where it is impure."""
    schema = getattr(node.target, "_schema", None)
    if node.op != "call_function" or schema is None:
        inputs = node.all_input_nodes
        writes = node.op == "call_method" or (node.op in _CALLS and node.is_impure())
        return inputs, inputs if writes else []
    shared, written = [], []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None:
            continue
        nodes = _nodes(node.args[i] if i < len(node.args) else node.kwargs.get(arg.name))
        shared += nodes
        if arg.alias_info.is_write and node.target is not torch.ops.aten.detach_.default:
            written += nodes
    return shared, written


def _pure(node, module):
    """An operator call free of side effects and of random draws, or a
    grad-mode region of such calls; a Python function (functorch's vmap
    levels) never is."""
    if node.op != "call_function":
        return False
    target = node.target
    if target in _PURE:
        return True
    if target is getattr(torch.ops.higher_order, "wrap_with_set_grad_enabled", None):
        body = _attr(module, node.args[1].target)
        return all(_pure(n, body) for n in body.graph.nodes if n.op in _CALLS)
    return (isinstance(target, torch._ops.OpOverload) and not node.is_impure()
            and not _NONDETERMINISTIC.intersection(target.tags))


def _static(val):
    """A tensor of fixed shape, or a tuple of them."""
    if isinstance(val, (tuple, list)):
        return bool(val) and all(_static(v) for v in val)
    return isinstance(val, torch.Tensor) and all(isinstance(d, int) for d in val.shape)


def _constant(node, const, module):
    """Whether `node` is a constant of the program: frozen state (a tensor,
    or a grad-mode region's graph), or a pure call on constants only whose
    value is a tensor of fixed shape, a tuple of them that is only indexed,
    or nothing that anything reads."""
    if node.op == "get_attr":
        return isinstance(_attr(module, node.target), (torch.Tensor, torch.fx.GraphModule))
    val = node.meta.get("val")
    return (_pure(node, module) and all(a in const for a in node.all_input_nodes)
            and (_static(val) and (isinstance(val, torch.Tensor)
                                   or all(u.target is operator.getitem for u in node.users))
                 or val is None and not node.users))


def _constant_region(region, const, module, levels):
    """Whether a vmap region is constant as a whole: pure calls and the
    vmap's own, on constants or on each other, its results of fixed shape."""
    inside = set(region)
    for node in region:
        if node.target not in levels and not _pure(node, module):
            return False
        if any(a not in const and a not in inside for a in node.all_input_nodes):
            return False
        val = node.meta.get("val")
        if any(u not in inside for u in node.users) and not (
                isinstance(val, torch.Tensor) and _static(val)):
            return False
    return True


def _fold(module):
    """Fold the part of an unlifted program (`ExportedProgram.module()`)
    that depends only on its frozen state, in place: evaluate it once, keep
    as buffers the values that per-call operations or the outputs read, and
    drop the rest. A node that reads a request argument, a symbolic size, a
    random draw or storage that an in-place operation writes stays per
    call, so the answers are those of the unfolded program. A vmap folds
    whole or not at all (its levels are state of the process)."""
    graph = module.graph
    before = sum(n.op in _CALLS for n in graph.nodes)
    # storage classes: a node with the inputs it may share storage with
    root = {}

    def find(n):
        while root.get(n, n) is not n:
            n = root[n]
        return n

    written = []
    for node in graph.nodes:
        shared, writes = _aliases(node)
        for a in shared:
            ra, rn = find(a), find(node)
            if ra is not rn:
                root[ra] = rn
        written += writes
    mutated = {find(n) for n in written}

    load, inc, dec, levels = _functorch()
    regions = {r[0]: r for r in _vmap_regions(graph, load, inc, dec)}
    const = {}  # insertion-ordered: the graph's order
    for node in graph.nodes:
        if node in const:
            continue
        region = regions.get(node)
        if region is not None and all(find(n) not in mutated for n in region) \
                and _constant_region(region, const, module, levels):
            const.update(dict.fromkeys(region))
        elif find(node) not in mutated and _constant(node, const, module):
            const[node] = None
    kept = {n for n in const if any(u not in const for u in n.users)}
    left = {n: sum(u in const for u in n.users) for n in const}
    frozen = {t.untyped_storage().data_ptr() for t in module.buffers()}
    frozen |= {t.untyped_storage().data_ptr() for t in module.parameters()}
    env, kept_bytes, storages = {}, 0, set()

    def release(n):  # an intermediate after its last reader
        if not left[n] and n not in kept:
            del env[n]

    with torch.no_grad():
        for node in const:  # in order: a vmap's levels rise and fall as in a call
            if node.op == "get_attr":
                env[node] = _attr(module, node.target)
            else:
                env[node] = node.target(*torch.fx.node.map_arg(node.args, env.__getitem__),
                                        **torch.fx.node.map_arg(node.kwargs, env.__getitem__))
            for a in node.all_input_nodes:
                left[a] -= 1
                release(a)
            release(node)
    for i, node in enumerate(n for n in const if n in kept and n.op != "get_attr"):
        value, name = env.pop(node), "_folded%d" % i
        module.register_buffer(name, value, persistent=False)
        with graph.inserting_before(node):
            attr = graph.get_attr(name)
        attr.meta.update(node.meta)
        node.replace_all_uses_with(attr, delete_user_cb=lambda u: u not in const)
        for out in [u for u in attr.users if u.op == "output"]:
            with graph.inserting_before(out):  # an answer the caller may write into
                copy = graph.call_function(torch.ops.aten.clone.default, (attr,))
            copy.meta.update(node.meta)
            out.replace_input_with(attr, copy)
        ptr = value.untyped_storage().data_ptr()
        if ptr not in frozen and ptr not in storages:
            storages.add(ptr)
            kept_bytes += value.untyped_storage().nbytes()
    for node in reversed(graph.nodes):  # the folded nodes and the reads left unread
        if not node.users and (node in const or node.op == "get_attr"):
            graph.erase_node(node)
    graph.lint()
    module.recompile()
    after = sum(n.op in _CALLS for n in graph.nodes)
    return FoldRecord(before - after, after, kept_bytes)


class ServingArtifact:
    """Exported programs, one per platform: call it like a function,
    ``save`` it to disk or ``serialize()`` it to bytes."""

    def __init__(self, programs):
        # {platform: ExportedProgram or its serialized bytes}
        self._programs = dict(programs)
        self._modules = {}
        self._in_specs = {}
        self._folds = {}

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
            module = self._program(platform).module()
            self._folds[platform] = _fold(module)
            self._modules[platform] = module
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
    def folds(self):
        """``{platform: FoldRecord}`` of the programs called so far (a
        read-only view)."""
        return types.MappingProxyType(self._folds)

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
