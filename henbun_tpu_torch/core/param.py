"""Parameter-tree core: Parentable / Variable / Parameterized / ParamList /
Data / MinibatchData and the ``graph_key`` collection tags.

* Variables are leaves holding a committed *free-space* value (a numpy
  array at construction, a tensor once a training loop writes one back)
  plus deferred-assignment state: ``assign`` stages, ``initialize``
  commits, ``finalize`` clears the flag.
* Inside an objective's trace (:mod:`henbun_tpu_torch.core.context`),
  attribute access on a ``Parameterized`` returns the node's tensor
  (transformed parameter / data / posterior sample), and attribute
  *assignment* to a LOCAL node performs the feed.
* Parameters move as plain dicts ``{tree-path: free-space tensor}``
  (``param_dict`` / ``set_param_dict``), keyed by the same dotted paths as
  the JAX package, so weights carry over between the two.
* Collections are string tags that pick the trainable subset; ``LOCAL``
  and ``DATA`` are the two non-parameter kinds.
* The amortized-inference feed unpacks an encoder slab
  ``[*n_layers, N, sum(feed_size)]`` to each LOCAL leaf by last-axis
  offsets in recursive name-sorted order.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import transforms
from .._settings import settings, np_float
from ..scoping import NameScoped
from . import context as _ctx
from . import rng as _rng


class _GraphKey:
    """Collection tags distinguishing Variable kinds."""

    def __init__(self):
        self.VARIABLES = "variables"  # default trainable-global tag
        self.LOCAL = "LOCAL"
        self.DATA = "DATA"

    @property
    def not_parameters(self):
        return [self.LOCAL, self.DATA]


graph_key = _GraphKey()


def _float_type():
    return settings.dtypes.float_type


def _to_numpy(x):
    """Host numpy copy of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tree_device(node):
    """The device of the tree a node belongs to: its root Model's, else the
    CPU (a subtree not yet attached to a Model)."""
    root = node.highest_parent
    return object.__getattribute__(root, "__dict__").get(
        "_device", torch.device("cpu")
    )


def _in_collections(collection, collections):
    """Is `collection` matched by a Variable's `collections` attribute?
    `collections` is either a list of string tags (global parameters) or the
    string 'LOCAL'/'DATA'."""
    if collection is None:
        return True
    if isinstance(collections, str):
        return collection == collections
    return collection in collections


class Parentable:
    """Tree node with a `_parent` backref; the name is found in the
    parent's __dict__."""

    def __init__(self):
        self._parent = None

    @property
    def highest_parent(self):
        if self._parent is None:
            return self
        return self._parent.highest_parent

    @property
    def name(self):
        if self._parent is None:
            return "unnamed"
        if isinstance(self._parent, ParamList):
            return "item%i" % self._parent._list.index(self)
        matches = [
            key
            for key, value in self._parent.__dict__.items()
            if value is self
        ]
        if len(matches) == 0:
            raise ValueError(
                "mis-specified parent. This Param's _parent does not contain a "
                "reference to it."
            )
        if len(matches) > 1:
            raise ValueError("This Param appears to be doubly referenced by a parent")
        return matches[0]

    @property
    def long_name(self):
        if self._parent is None:
            return self.name
        return self._parent.long_name + "." + self.name

    def path_to(self, ancestor):
        """Dotted path of this node relative to `ancestor`, or None if the
        node is not in `ancestor`'s tree. The key into the trace context's
        params/data/feeds dicts."""
        if self is ancestor:
            return ""
        parts = []
        node = self
        while node is not ancestor:
            if node._parent is None:
                return None
            parts.append(node.name)
            node = node._parent
        return ".".join(reversed(parts))

    def _trace_path(self, ctx):
        return self.path_to(ctx.root)


class Variable(Parentable):
    """Leaf node: a global parameter, LOCAL (fed) parameter, or data slot.

    Full array shape is ``[*n_layers, (n_batch,) *shape]``. Global
    variables are initialized truncated-normal in free space; transforms map
    free space to the constrained space on access.
    """

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        mean=0.0,
        stddev=1.0,
        transform=None,
        collections=None,
    ):
        Parentable.__init__(self)
        if isinstance(shape, int):
            shape = [shape]
        self.transform = transform if transform is not None else transforms.Identity()
        self.collections = collections if collections is not None else [graph_key.VARIABLES]
        self.n_batch = n_batch
        self.shape = list(shape)
        self.n_layers = list(n_layers)
        self._assigned = True
        self._pending = None   # staged free-space value (deferred assignment)
        self._free = None      # committed free-space value
        if self.collections not in graph_key.not_parameters:
            if self.n_batch is None:
                full = list(self.n_layers) + list(self.shape)
            else:
                full = list(self.n_layers) + [self.n_batch] + list(self.shape)
            init = _rng.truncated_normal(
                full, mean=mean, stddev=stddev, dtype=np_float()
            )
            self._free = init
            self._pending = init

    # --- trace-mode access -------------------------------------------------
    def tensor(self):
        """The transformed tensor for this leaf inside a trace; outside a
        trace, the transformed committed value on the tree's device."""
        ctx = _ctx.current()
        path = self._trace_path(ctx) if ctx is not None else None
        if self.collections is graph_key.DATA:
            if ctx is not None and path is not None and path in ctx.data:
                return ctx.data[path]
            return self.device_value(_tree_device(self))
        if self.collections is graph_key.LOCAL:
            if ctx is None or path is None or path not in ctx.feeds:
                raise ValueError(
                    "local variable " + self.long_name + " is not fed."
                )
            return self.transform.tf_forward(ctx.feeds[path])
        # global parameter
        if ctx is not None and path is not None and path in ctx.params:
            free = ctx.params[path]
        else:
            free = torch.as_tensor(self._free, device=_tree_device(self))
        return self.transform.tf_forward(free)

    # --- collection queries ------------------------------------------------
    def get_variables(self, collection=None):
        if _in_collections(collection, self.collections):
            return [self]
        return []

    # --- deferred assignment lifecycle -------------------------------------
    def assign(self, value):
        if self.collections not in graph_key.not_parameters:
            self._pending = np.asarray(
                self.transform.backward(np.asarray(value, dtype=np_float())),
                dtype=np_float(),
            )
            self._assigned = True

    @property
    def initialize_ops(self):
        """Leaves with a staged assignment pending commit."""
        if self.collections not in graph_key.not_parameters and self._assigned:
            return [self]
        return []

    def _commit(self):
        if self._pending is not None:
            self._free = np.asarray(self._pending)

    def initialize(self):
        self._commit()
        self.finalize()

    def finalize(self):
        self._assigned = False

    @property
    def value(self):
        """Current (constrained-space) value as numpy. Commits any staged
        assignment first."""
        if self._assigned and self.collections not in graph_key.not_parameters:
            self._commit()
            self.finalize()
        return np.asarray(self.transform.forward(_to_numpy(self._free)))

    @property
    def free_value(self):
        """Committed free-space value (the optimizer-visible array)."""
        return self._free

    def set_free_value(self, free):
        """Directly set the committed free-space value (the training loop
        writes optimized parameters back this way)."""
        if isinstance(free, torch.Tensor):
            free = free.detach().clone()
        self._free = free
        self._assigned = False
        self._pending = None

    # --- amortized feeding ---------------------------------------------------
    @property
    def feed_size(self):
        if self.collections is graph_key.LOCAL:
            return int(np.prod(self.shape)) if self.shape else 1
        return 0

    def feed(self, x):
        """Feed a ``[*n_layers, N, feed_size]`` tensor into this LOCAL leaf;
        the flattened trailing axis is reshaped back to `shape`."""
        if self.collections is not graph_key.LOCAL:
            return
        ctx = _ctx.current()
        if ctx is None:
            raise RuntimeError(
                "feed() outside a trace: local variables only exist inside a "
                "traced objective."
            )
        if self.n_batch is not None and x.shape[-2] != self.n_batch:
            raise ValueError(
                "fed batch %d != n_batch %d for %s"
                % (x.shape[-2], self.n_batch, self.long_name)
            )
        new_shape = tuple(self.n_layers) + (x.shape[-2],) + tuple(self.shape)
        ctx.feeds[self._trace_path(ctx)] = torch.reshape(x, new_shape)

    def get_feed_dict(self, minibatch_index=None):
        if self.collections is graph_key.DATA:
            raise NotImplementedError
        return {}


class Parameterized(Parentable):
    """Container node holding Variables / other Parameterized children.

    Attribute access inside a trace returns child tensors; attribute
    assignment inside a trace feeds LOCAL children.
    """

    def __init__(self):
        Parentable.__init__(self)
        self.scoped_keys = []

    # --- trace-mode attribute swap ------------------------------------------
    def __getattribute__(self, key):
        o = object.__getattribute__(self, key)
        if key.startswith("_"):
            return o
        ctx = _ctx.current()
        if ctx is None:
            return o
        # only nodes inside the traced tree participate
        if isinstance(o, (Parameterized, Variable)) and hasattr(o, "tensor"):
            if o.path_to(ctx.root) is not None:
                return o.tensor()
            return o
        try:
            scoped = object.__getattribute__(self, "scoped_keys")
        except AttributeError:
            scoped = ()
        if (
            key in scoped
            and torch.autograd._profiler_enabled()
            and self.path_to(ctx.root) is not None
        ):
            return NameScoped(self.long_name + "." + key)(o)
        return o

    def __setattr__(self, key, value):
        if key in self.__dict__:
            p = object.__getattribute__(self, key)
            ctx = _ctx.current()
            # inside a trace, assignment to a child node is a feed
            if ctx is not None and isinstance(p, (Variable, Parameterized)):
                if p.path_to(ctx.root) is not None:
                    p.feed(value)
                    return
            if isinstance(p, Variable):
                if isinstance(value, (float, int)):
                    value = np.array([value], dtype=np_float())
                if isinstance(value, (np.ndarray, torch.Tensor)):
                    p.assign(_to_numpy(value))
                    return
            if isinstance(p, (Variable, Parameterized)) and isinstance(
                value, (Variable, Parameterized)
            ):
                p._parent = None  # unlink the replaced node

        object.__setattr__(self, key, value)

        if isinstance(value, Parentable) and key != "_parent":
            value._parent = self

    # --- tree recursion ------------------------------------------------------
    @property
    def sorted_variables(self):
        """Direct children (Variable or Parameterized), name-sorted for a
        deterministic order."""
        variables = [
            child
            for key, child in self.__dict__.items()
            if isinstance(child, (Variable, Parameterized)) and key != "_parent"
        ]
        return sorted(variables, key=lambda x: x.name)

    def get_variables(self, collection=None):
        params = []
        for p in self.sorted_variables:
            params += p.get_variables(collection)
        return params

    @property
    def initialize_ops(self):
        params = []
        for p in self.sorted_variables:
            params += p.initialize_ops
        return params

    def finalize(self):
        for p in self.sorted_variables:
            p.finalize()

    def initialize(self):
        """Commit all staged assignments in the subtree."""
        for v in self.initialize_ops:
            v._commit()
        self.finalize()

    # --- functional param/data dict building ---------------------------------
    def param_dict(self, collection=None, exclude=None):
        """{relative-path: free-space tensor} over global Variables, on the
        tree's device. With `collection`, only matching tags; with
        `exclude`, only NON-matching tags (used to build the frozen set).
        The tensors are copies: changing them leaves the tree as it is."""
        device = _tree_device(self)
        out = {}
        for v in self.get_variables():
            if v.collections in graph_key.not_parameters:
                continue
            if exclude is not None and _in_collections(exclude, v.collections):
                continue
            if exclude is None and not _in_collections(collection, v.collections):
                continue
            free = v.free_value
            if isinstance(free, torch.Tensor):
                out[v.path_to(self)] = free.detach().to(device).clone()
            else:
                out[v.path_to(self)] = torch.tensor(np.asarray(free), device=device)
        return out

    def set_param_dict(self, values):
        """Write free-space values (tensors or arrays) into the tree
        leaves."""
        lookup = {v.path_to(self): v for v in self.get_variables()}
        for path, val in values.items():
            lookup[path].set_free_value(val)

    def data_dict(self):
        """{relative-path: full data array (numpy)} over Data descendants."""
        out = {}
        for v in self.get_variables(graph_key.DATA):
            out[v.path_to(self)] = v.data
        return out

    # --- amortized feeding ---------------------------------------------------
    @property
    def feed_size(self):
        return int(
            np.sum([p.feed_size for p in self.get_variables(graph_key.LOCAL)], dtype=int)
        )

    def feed(self, x):
        """Feed tensor x into all LOCAL descendants by slicing the last axis
        at feed_size offsets, recursively in name-sorted child order."""
        locals_ = self.get_variables(graph_key.LOCAL)
        if len(locals_) == 0:
            return
        n_layers = locals_[0].n_layers
        for p in locals_:
            if list(p.n_layers) != list(n_layers):
                raise ValueError(
                    "n_layers of all the LOCAL variables should be same for "
                    "using this method. If not, feed separately by hand "
                    "instead."
                )
        begin = 0
        for p in self.sorted_variables:
            fs = p.feed_size
            if fs > 0:
                p.feed(x[..., begin : begin + fs])
            begin += fs

    def get_feed_dict(self, minibatch_index=None):
        feed_dict = {}
        for p in self.sorted_variables:
            feed_dict.update(p.get_feed_dict(minibatch_index))
        return feed_dict

    # --- KL aggregation --------------------------------------------------------
    def KL(self, collection=None):
        kl_list = [
            p.KL(collection) for p in self.sorted_variables if hasattr(p, "KL")
        ]
        if len(kl_list) == 0:
            return torch.zeros([], dtype=_float_type(), device=_tree_device(self))
        out = kl_list[0]
        for k in kl_list[1:]:
            out = out + k
        return out

    def describe(self):
        """Human-readable tree summary: one line per leaf with shape,
        transform, collections, plus a parameter-count total."""
        lines = []
        total = 0
        for v in self.get_variables():
            kind = (
                v.collections
                if isinstance(v.collections, str)
                else ",".join(map(str, v.collections))
            )
            if v.collections in graph_key.not_parameters:
                shape = tuple(getattr(v, "shape", ()))
                if v.collections is graph_key.DATA:
                    shape = np.shape(getattr(v, "data", ()))
            else:
                shape = tuple(_to_numpy(v.free_value).shape)
                total += int(np.prod(shape)) if shape else 1
            lines.append(
                "%-40s %-16s %-12s %s"
                % (v.path_to(self) or v.name, str(shape), kind, str(v.transform))
            )
        lines.append("trainable parameters: %d" % total)
        return "\n".join(lines)

    # --- checkpointing -----------------------------------------------------
    def save(self, save_path=None, global_step=None):
        """Save the subtree's global parameters, keyed by long_name, as an
        .npz archive (the JAX package's format). Returns the path written."""
        from ..utils import checkpoint as _chk

        return _chk.save(self, save_path, global_step=global_step)

    def restore(self, save_path=None):
        from ..utils import checkpoint as _chk

        _chk.restore(self, save_path)


class ParamList(Parameterized):
    """An ordered container of parameters; children are named item%i."""

    def __init__(self, list_of_params=[]):
        Parameterized.__init__(self)
        for item in list_of_params:
            if not isinstance(item, (Variable, Parameterized)):
                raise TypeError("ParamList holds Variables and Parameterized")
            item._parent = self
        self._list = list(list_of_params)

    @property
    def sorted_variables(self):
        return self._list

    def __len__(self):
        return len(self._list)

    def __getitem__(self, key):
        o = self._list[key]
        ctx = _ctx.current()
        # the same swap rule as Parameterized.__getattribute__: any node
        # exposing tensor() (Variable, Variational) yields its tensor
        if (
            ctx is not None
            and isinstance(o, (Variable, Parameterized))
            and hasattr(o, "tensor")
            and o.path_to(ctx.root) is not None
        ):
            return o.tensor()
        return o

    def append(self, item):
        if not isinstance(item, (Variable, Parameterized)):
            raise TypeError("this object is for containing parameters")
        item._parent = self
        self._list.append(item)

    def __setitem__(self, key, value):
        p = self._list[key]
        if isinstance(value, np.ndarray):
            p.assign(value)
            return
        elif isinstance(value, (float, int)):
            p.assign(np.array([value], dtype=np_float()))
            return
        raise TypeError


class Data(Variable):
    """Data slot. The array is kept on the host and copied to the tree's
    device once (``device_value``); the copy is reused until the data is
    rebound."""

    def __init__(self, data):
        data = np.asarray(data)
        Variable.__init__(
            self, data.shape, n_layers=[], n_batch=None, collections=graph_key.DATA
        )
        self.data = self._cast(data)

    def _cast(self, array):
        if array.dtype in (np.float32, np.float64):
            return np.asarray(array, dtype=np_float())
        if array.dtype in (np.int16, np.int32, np.int64):
            return np.asarray(array, dtype=np.int32)
        raise NotImplementedError("unknown dtype %r" % array.dtype)

    def get_feed_dict(self, minibatch_index=None):
        return {self: self.data}

    def device_value(self, device=None):
        """The data as a tensor on `device` (default: the tree's device),
        cached until `data` is rebound."""
        device = torch.device(device) if device is not None else _tree_device(self)
        key = (id(self.data), device)
        if getattr(self, "_dev_of", None) != key:
            self._dev = torch.as_tensor(self.data, device=device)
            self._dev_of = key
        return self._dev

    def assign(self, value):
        value = np.asarray(value)
        if value.shape != self.data.shape:
            raise ValueError("The shape of data must be the same.")
        self.data = self._cast(value)

    @property
    def value(self):
        return self.data


class MinibatchData(Data):
    """Data whose first axis is the minibatch axis. The full array stays on
    the device; the training step gathers its minibatch there."""

    def __init__(self, data):
        data = np.asarray(data)
        Variable.__init__(
            self, data.shape[1:], n_layers=[], n_batch=None, collections=graph_key.DATA
        )
        self.data = self._cast(data)

    @property
    def data_size(self):
        return self.data.shape[0]

    def get_feed_dict(self, minibatch_index):
        if minibatch_index is None:
            return {}
        return {self: self.data[minibatch_index]}
