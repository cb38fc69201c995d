"""Sharded training over a device mesh: data-parallel steps
(:class:`ShardedOptimizer`) and fleets split over ranks
(:class:`ShardedBatchedOptimizer`).

Where the JAX package lets GSPMD insert the collectives from sharding
annotations, each rank here runs the single-device driver on its share
and the collectives are written out on the mesh dimension's process group:
one all-reduce of the gradients (and the objective) a step for the data
dimension, with the all-reduces of a row-sharded full-batch objective's
row sums inside the step (``parallel/rows.py``); one all-reduce of the
fleet's summed objective a step for the chain dimension. Both optimizers
are subclasses of the single-device ones, so nan-guard rollback,
callbacks, StepMetrics and both minibatch modes are inherited; a
non-finite value on one rank reaches every rank through the all-reduce,
so all ranks roll back together.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..batched import BatchedOptimizer
from ..model import Optimizer, _resolve_method
from . import mesh as mesh_mod
from . import rows


# the optimizers' all-reduces (gradients, objective, diagnostics): calls and
# bytes, the counterpart of the JAX tests' reading of the compiled step's
# collectives; a row-sharded objective's own are counted in rows.stats
stats = {"calls": 0, "bytes": 0}


def reset_stats():
    stats.update(calls=0, bytes=0)


def _flat_all_reduce(tensors, group, op=dist.ReduceOp.SUM):
    """All-reduce a list of tensors as one flat buffer (counted in
    :data:`stats`); returns the reduced tensors (new ones, in the inputs'
    shapes)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    stats["calls"] += 1
    stats["bytes"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat, op=op, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


class _Recorder:
    """Trace noise that records each draw's path, shape and dtype in draw
    order and stands zeros in for it."""

    def __init__(self, device):
        self.device = device
        self.shapes = {}

    def draw(self, path, shape, dtype):
        self.shapes[path] = (tuple(int(s) for s in shape), dtype)
        return torch.zeros(shape, dtype=dtype, device=self.device)


def _noise_shapes(opt, trainable, frozen, data):
    """{path: (shape, dtype)} of the draws one evaluation of `opt`'s
    single-model objective takes at these parameters and data."""
    rec = _Recorder(opt.device)
    with torch.no_grad():
        Optimizer._objective(opt, {})(trainable, frozen, data, None, rec)
    return rec.shapes


def _signature(data):
    return tuple(sorted((k, tuple(v.shape)) for k, v in data.items()))


class _BlockNoise:
    """Trace noise for one data rank: a draw whose shape grows with the
    rows along axis `axes[path]` is drawn for all n ranks' rows from the
    shared generator and this rank's block kept; every other draw is the
    plain one, the same on every rank."""

    def __init__(self, generator, axes, n, rank):
        self.generator, self.axes, self.n, self.rank = generator, axes, n, rank

    def draw(self, path, shape, dtype):
        g, a = self.generator, self.axes.get(path)
        if a is None:
            return torch.randn(shape, generator=g, dtype=dtype, device=g.device)
        full = list(shape)
        full[a] *= self.n
        u = torch.randn(full, generator=g, dtype=dtype, device=g.device)
        return u.narrow(a, self.rank * shape[a], shape[a])


class ShardedOptimizer(Optimizer):
    """Data-parallel subclass of :class:`henbun_tpu_torch.model.Optimizer`.

    Parameters replicate: rank 0's are broadcast at ``compile`` (with any
    optimizer state on the device). Each rank keeps its 1/n_data share of
    every MinibatchData array's permuted train split (the split truncated
    to a multiple of n_data; the permutation is rank 0's), draws its
    B/n_data rows a step from that shard in either minibatch mode, and
    evaluates the objective as a minibatch of that local size. After
    ``backward()`` the gradients and the objective are all-reduced as a
    mean over ``data``.

    For an objective "scale x sum over rows + global terms", with scale the
    data size over the rows evaluated, each rank's value is an unbiased
    estimate and the mean of the ranks' is exactly the global B-row
    objective that the JAX package's GSPMD program differentiates (the B
    rows being the union of the ranks'), and so is the mean gradient.

    A full-batch objective (``minibatch_size=None``) runs whole on every
    rank, unless it is declared ``parallel.rows.row_sharded`` (the
    sparse Laplace and EP evidence): then each data rank takes one
    contiguous block of every MinibatchData array's rows (all of them, as
    the one-process full-batch step; n rows over k ranks give the first
    n mod k blocks one row more) and evaluates the step inside
    ``rows.sharded_rows``, where the objective's row sums are
    all-reduced; the mean of the ranks' gradients is then the one-process
    gradient (the derivation is in ``parallel/rows.py``). The JAX package
    gets the same split from GSPMD, which shards every MinibatchData
    array over ``data`` whatever the batch.

    Build the model with the same seed on every rank: the ranks' model
    generators then stay in step, and every draw is one global draw. The
    rows: each rank draws the [n_data, B/n_data] table of shard offsets (the
    n_data block starts in 'block' mode) and keeps its own row. The noise:
    a draw that grows with the rows (a LOCAL node's, a conditional over
    the minibatch) is drawn for all B rows and each rank keeps its block;
    every other draw (a global node's) is the same on every rank. So with
    the rows injected, the n-rank step takes the one-process step's noise
    on the union of the rows. Which axis of a draw holds the rows is found
    once for each data shape, by evaluating the objective at B/n_data rows
    and at one row more with zeros for the noise.
    """

    def __init__(self, model, likelihood_method, mesh=None):
        super().__init__(model, _resolve_method(model, likelihood_method))
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(
            device_type=model.device.type)
        self._group = self.mesh.get_group(mesh_mod.DATA_AXIS)
        self._minibatched = False
        self._row_block = None  # this rank's (start, stop) of a row-sharded full batch
        self._axes = {}  # {data signature: {path: row axis}}

    def _n_data(self):
        return self.mesh.size(self.mesh.mesh_dim_names.index(mesh_mod.DATA_AXIS))

    def _rank(self):
        return self.mesh.get_local_rank(mesh_mod.DATA_AXIS)

    def _row_axes(self, d):
        """{path: the axis of the draw at `path` that holds the rows} for
        a step on data `d`, from its draws' shapes at d's rows and at one
        row more."""
        key = _signature(d)
        if key not in self._axes:
            k = next(d[p].shape[0] for p in self._mb_paths if p in d)
            more = self._take_rows(d, torch.arange(k + 1, device=self.device) % k)
            at_k = _noise_shapes(self, self._trainable, self._frozen, d)
            at_more = _noise_shapes(self, self._trainable, self._frozen, more)
            axes = {}
            for path, (s, _) in at_k.items():
                t = at_more.get(path, (s, None))[0]
                grown = [i for i in range(len(s)) if len(t) == len(s) and s[i] != t[i]]
                if len(t) != len(s) or len(grown) > 1 or (
                        grown and t[grown[0]] != s[grown[0]] + 1):
                    raise ValueError(
                        "the noise at %r has shape %s at %d rows and %s at %d: a "
                        "ShardedOptimizer splits a draw over ranks along one row "
                        "axis only" % (path, s, k, t, k + 1))
                if grown:
                    axes[path] = grown[0]
            self._axes[key] = axes
        return self._axes[key]

    def _step(self, d, noise):
        if self._row_block is not None:
            with rows.sharded_rows(self._group):
                return super()._step(d, noise)
        if noise is None and self._minibatched and self._n_data() > 1:
            axes = self._row_axes(d)
            if axes:
                noise = _BlockNoise(self.model.generator, axes, self._n_data(), self._rank())
        return super()._step(d, noise)

    def _broadcast(self, t):
        dist.broadcast(t, src=dist.get_global_rank(self._group, 0), group=self._group)

    def compile(self, *args, **kwargs):
        super().compile(*args, **kwargs)
        with torch.no_grad():
            for t in self._trainable.values():
                self._broadcast(t)
            for state in self.torch_optimizer.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor) and v.device == self.device:
                        self._broadcast(v)
        self._commit_params(self._trainable)
        return self

    def _reduce_step(self, val, diags):
        params = [p for p in self._trainable.values() if p.grad is not None]
        reduced = _flat_all_reduce([p.grad for p in params] + [val.reshape(1)], self._group)
        nd = self._n_data()
        for p, g in zip(params, reduced):
            p.grad.copy_(g / nd)
        val = (reduced[-1] / nd).reshape(val.shape)
        if diags:
            names = sorted(diags)
            worst = _flat_all_reduce([diags[k].reshape(1) for k in names], self._group,
                                     dist.ReduceOp.MAX)
            diags = {k: w.reshape(diags[k].shape) for k, w in zip(names, worst)}
        return val, diags

    def _prepare_optimize_data(self, data, minibatch_size, mode):
        """This rank's shard of the permuted train split, gathered once an
        optimize() call: rows [r L, (r + 1) L) of the split truncated to
        n_data L rows. Returns (shard data, None, L)."""
        self._minibatched = minibatch_size is not None
        self._row_block = None
        if minibatch_size is None:
            if self._n_data() > 1 and self._mb_paths and rows.is_row_sharded(
                    self.likelihood_method):
                return self._row_shard(data), None, 1
            return data, None, 1
        model = self.model
        if model._index.data_size is None:
            raise ValueError(
                "minibatch_size=%r was passed but model %r has no "
                "MinibatchData — declare minibatched arrays with "
                "hb.MinibatchData, or drop minibatch_size."
                % (minibatch_size, model.name)
            )
        nd = self._n_data()
        if minibatch_size % nd != 0:
            raise ValueError(
                "minibatch_size=%d must be divisible by the mesh data-axis "
                "size %d (each rank takes an equal share of the batch)."
                % (minibatch_size, nd)
            )
        train_idx = torch.as_tensor(np.asarray(model._index._train_index), device=self.device)
        self._broadcast(train_idx)  # every rank shards rank 0's permutation
        local_n = len(train_idx) // nd
        if local_n == 0:
            raise ValueError(
                "train split (%d rows) is smaller than the mesh data axis "
                "(%d ranks)." % (len(train_idx), nd)
            )
        r = self._rank()
        return self._take_rows(data, train_idx[r * local_n:(r + 1) * local_n]), None, local_n

    def _row_shard(self, data):
        """This rank's contiguous block of every MinibatchData array's rows
        for a row-sharded full batch; records the block."""
        n = next(data[p].shape[0] for p in self._mb_paths if p in data)
        nd, r = self._n_data(), self._rank()
        size, extra = divmod(n, nd)
        if size == 0:
            raise ValueError(
                "%d rows cannot be split over the mesh data axis (%d ranks)" % (n, nd))
        start = r * size + min(r, extra)
        stop = start + size + (r < extra)
        self._row_block = (start, stop)
        return {path: arr[start:stop] if path in self._mb_paths else arr
                for path, arr in data.items()}

    def _make_select_batch(self, minibatch_size, train_size, mode):
        """B/n_data rows a step from this rank's shard of `train_size`
        rows: uniform with replacement ('random') or a random contiguous
        block ('block'). Every rank draws all ranks' offsets (or block
        starts) and keeps its own, so the ranks' draws are independent and
        their generators stay in step."""
        if minibatch_size is None:
            return lambda data, train_idx, g: data
        if mode not in ("random", "block"):
            raise ValueError("minibatch_mode must be 'random' or 'block'")
        nd, r = self._n_data(), self._rank()
        local_mb = int(minibatch_size) // nd

        def select(data, train_idx, g):
            if mode == "block":
                hi = max(train_size - local_mb + 1, 1)
                start = torch.randint(0, hi, (nd, 1), generator=g, device=g.device)[r]
                rows = start + torch.arange(local_mb, device=g.device)
            else:
                rows = torch.randint(0, train_size, (nd, local_mb), generator=g,
                                     device=g.device)[r]
            return self._take_rows(data, rows)

        return select

    def save_state(self, path):
        """Every rank holds the same state: data rank 0 writes it."""
        if self._rank() == 0:
            super().save_state(path)
        dist.barrier(group=self._group)


class ShardedBatchedOptimizer(BatchedOptimizer):
    """A fleet of M independent fits split over the mesh's ``chain``
    dimension: each rank trains its M / n_chain models (a contiguous block)
    as a BatchedOptimizer, so a fleet of n <= 128 still reaches K1 and K2
    on every rank. The only collective a step is the all-reduce of the
    summed objective for the history (and of the reported diagnostics'
    maximum, where the objective reports any). When ``optimize`` ends,
    each rank's trained parameters are gathered so that every model of
    ``all_models`` holds its fit on every rank.

    ``models`` are all M models, built alike on every rank; ``self.models``
    are this rank's. As in the unsharded fleet, the rows and the noise are
    drawn from model 0's generator (and the rows through model 0's train
    split): every rank draws them for all M models and keeps its block, so
    the sharded fleet takes the unsharded fleet's draws model for model.
    Which draws an evaluation takes is found once for each data shape by
    evaluating model 0's objective with zeros for the noise.
    ``save_state`` saves this rank's models: give each rank its own path.
    """

    def __init__(self, models, likelihood_method, mesh=None):
        models = list(models)
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(
            n_data=1, n_chain=dist.get_world_size() if dist.is_initialized() else 1,
            device_type=models[0].device.type)
        n_chain = self.mesh.size(self.mesh.mesh_dim_names.index(mesh_mod.CHAIN_AXIS))
        if len(models) % n_chain:
            raise ValueError(
                "model count %d must divide evenly over the mesh 'chain' "
                "axis (%d ranks)" % (len(models), n_chain)
            )
        self.all_models = models
        self._group = self.mesh.get_group(mesh_mod.CHAIN_AXIS)
        self._block = mesh_mod.shard_rows(self.mesh, mesh_mod.CHAIN_AXIS, len(models))
        self._shapes = {}  # {data signature: model 0's draws}
        super().__init__(models[self._block], likelihood_method)
        self.model = models[0]  # the generator and train split the fleet draws from

    def _fleet_rows(self):
        return len(self.all_models), self._block

    def _prepare_models(self):
        """Every model of the fleet, in order, as the unsharded fleet
        prepares them: their train splits come from one host RNG."""
        local, self.models = self.models, self.all_models
        try:
            super()._prepare_models()
        finally:
            self.models = local

    def _objective(self, guards):
        """The fleet's objective; with more than one rank, its noise is the
        whole fleet's draws, this rank's block injected."""
        core = super()._objective(guards)
        if dist.get_world_size(self._group) == 1:
            return core

        def sharded(trainable, frozen, d, generator, noise):
            if noise is None:
                key = _signature(d)
                if key not in self._shapes:
                    self._shapes[key] = _noise_shapes(
                        self, *({k: v[0] for k, v in t.items()} for t in (trainable, frozen, d)))
                m = len(self.all_models)
                noise = {p: torch.randn((m,) + s, generator=generator, dtype=dtype,
                                        device=generator.device)[self._block]
                         for p, (s, dtype) in self._shapes[key].items()}
            return core(trainable, frozen, d, generator, noise)

        return sharded

    def _reduce_step(self, val, diags):
        (val,) = _flat_all_reduce([val.reshape(1)], self._group)
        val = val.reshape(())
        if diags:
            names = sorted(diags)
            worst = _flat_all_reduce([diags[k].reshape(1) for k in names], self._group,
                                     dist.ReduceOp.MAX)
            diags = {k: w.reshape(diags[k].shape) for k, w in zip(names, worst)}
        return val, diags

    def _commit_params(self, trainable):
        """Gather every rank's stacked parameters and commit all M fits."""
        size = dist.get_world_size(self._group)
        full = {}
        for k, v in trainable.items():
            parts = [torch.empty_like(v) for _ in range(size)]
            dist.all_gather(parts, v.detach().contiguous(), group=self._group)
            full[k] = torch.cat(parts)
        for i, m in enumerate(self.all_models):
            m.set_param_dict({k: v[i] for k, v in full.items()})
