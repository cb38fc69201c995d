"""Chains (and SMC particles) split over a mesh's ``chain`` dimension.

A sampler given ``mesh`` runs the chains of one contiguous block on each
rank. Every rank draws the whole [C, ...] noise from its generator (the
same seed on every rank) and keeps its own rows, so the n-rank run takes
the one-process run's draws chain for chain. Each cross-chain quantity is
computed from an all-gather over ``chain`` of the per-chain values, then
by the same arithmetic as in one process, so every rank agrees on it bit
for bit and the run equals the one-process run on the same chains. The
results are gathered at the end: a sampler returns the whole run on every
rank. Without a mesh every operation here is the identity.

Every collective is counted in :data:`stats`: calls, bytes of the
gathered (or reduced) result, and {its shape: calls}, the counterpart of
the JAX tests' reading of the compiled sampler's collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import mesh as mesh_mod

stats = {"calls": 0, "bytes": 0, "shapes": {}}


def reset_stats():
    stats.update(calls=0, bytes=0, shapes={})


def _count(shape, dtype):
    stats["calls"] += 1
    stats["bytes"] += int(torch.Size(shape).numel()) * dtype.itemsize
    stats["shapes"][tuple(shape)] = stats["shapes"].get(tuple(shape), 0) + 1


class ChainShard:
    """This rank's block of `n` chains over `mesh`'s chain dimension (all
    of them without a mesh), and the collectives over it."""

    def __init__(self, mesh, n):
        self.n = int(n)
        if mesh is None:
            self.group, self.size, self.rows = None, 1, slice(0, self.n)
        elif not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            "(parallel.make_mesh), got %r" % (type(mesh).__name__,))
        else:
            self.group = mesh.get_group(mesh_mod.CHAIN_AXIS)
            self.size = dist.get_world_size(self.group)
            self.rows = mesh_mod.shard_rows(mesh, mesh_mod.CHAIN_AXIS, self.n)
        self.local_n = self.rows.stop - self.rows.start

    def local(self, x, dim=0):
        """This rank's chains of a tensor whose `dim` runs over all."""
        return x if self.size == 1 else x.narrow(dim, self.rows.start, self.local_n)

    def gather(self, x, dim=0):
        """All chains of a tensor whose `dim` runs over this rank's."""
        if self.size == 1:
            return x
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8), dim).bool()
        x = x.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        _count((self.n,) + tuple(x.shape[1:]), x.dtype)
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).movedim(0, dim)

    def gather_rows(self, *xs):
        """:meth:`gather` of several [local_n] or [local_n, k] tensors in
        one all-gather."""
        if self.size == 1 or not xs:
            return xs
        cols = [x.reshape(x.shape[0], -1) for x in xs]
        full = self.gather(torch.cat(cols, 1))
        out, off = [], 0
        for x, c in zip(xs, cols):
            out.append(full[:, off:off + c.shape[1]].reshape((self.n,) + tuple(x.shape[1:]))
                       .contiguous())
            off += c.shape[1]
        return tuple(out)

    def any(self, flag):
        """Whether `flag` (a 0-d bool tensor) holds on any rank."""
        if self.size == 1:
            return flag
        f = flag.to(torch.int32).reshape(1)
        _count(f.shape, f.dtype)
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=self.group)
        return f[0] > 0
