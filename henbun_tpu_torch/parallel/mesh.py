"""Device meshes over ``torch.distributed``.

One ``DeviceMesh`` per job with named dimensions ``("data", "chain")``:
minibatch rows shard over ``data``, MCMC chains, SMC particles and the
models of a fleet over ``chain``, global parameters replicate. Where the
JAX package leaves the collectives to XLA's partitioner, the port's
drivers call them by hand on the mesh dimension's process group
(``mesh.get_group(DATA_AXIS)``): NCCL between cards, gloo on the CPU.

A process that has started no group gets a one-rank group of its own at
the first :func:`make_mesh` (a ``FileStore`` in a temporary directory: no
network, no port), so a one-card job needs no set-up, as a one-chip JAX
job needs none. A job of several processes calls
:func:`initialize_distributed` first, with the store or address every
rank shares.

The device type of a mesh or group is the caller's, else that of the
``[cuda] device`` setting, resolved as a Model's device is
(``_settings.resolve_device``): a CUDA device that is not there raises;
nothing falls back to gloo on the CPU.
"""
from __future__ import annotations

import os
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .._settings import resolve_device

DATA_AXIS = "data"
CHAIN_AXIS = "chain"


def _backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(init_method=None, world_size=None, rank=None, backend=None):
    """Start this process's group: ``init_process_group`` with `backend`
    (default NCCL for the ``[cuda] device`` setting's CUDA, gloo for
    ``cpu``; raises when the setting asks for a card that is not there),
    `init_method` (``"file:///path"``, shared by the ranks, or
    ``"tcp://host:port"``), `world_size` and `rank`. A no-op for a single
    process (world_size None or 1): :func:`make_mesh` then starts a
    one-rank group itself."""
    if world_size is None or world_size <= 1 or dist.is_initialized():
        return
    dist.init_process_group(backend or _backend(resolve_device().type),
                            init_method=init_method, world_size=world_size, rank=rank)


def _single_process_group(device_type):
    path = os.path.join(tempfile.mkdtemp(prefix="henbun_mesh_"), "store")
    dist.init_process_group(_backend(device_type), store=dist.FileStore(path, 1),
                            rank=0, world_size=1)


def make_mesh(n_data=None, n_chain=1, device_type=None):
    """A ``DeviceMesh`` of shape (n_data, n_chain) over the world, with
    dimensions ``("data", "chain")``. By default every rank goes to the
    data dimension. `device_type` (``"cuda"`` or ``"cpu"``) defaults to
    the ``[cuda] device`` setting's; a CUDA mesh without a card raises."""
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        _single_process_group(device_type)
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_chain
    if n_data * n_chain != n:
        raise ValueError("mesh %dx%d does not cover %d ranks" % (n_data, n_chain, n))
    return init_device_mesh(device_type, (n_data, n_chain),
                            mesh_dim_names=(DATA_AXIS, CHAIN_AXIS))


def replicated(mesh):
    """DTensor placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def data_sharded(mesh):
    """DTensor placements of a first axis sharded over ``data``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def chain_sharded(mesh):
    """DTensor placements of a first axis sharded over ``chain``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Replicate(), Shard(0))


def shard_rows(mesh, axis, n):
    """The slice of n leading rows this rank holds along mesh dimension
    `axis`: contiguous blocks of n // size (n must divide evenly)."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % size:
        raise ValueError("%d rows do not divide over the %r dimension (%d ranks)"
                         % (n, axis, size))
    k = n // size
    r = mesh.get_local_rank(axis)
    return slice(r * k, (r + 1) * k)


def shard_batch(mesh, arr):
    """This rank's rows of `arr` (its leading axis sharded over data)."""
    return arr[shard_rows(mesh, DATA_AXIS, arr.shape[0])]
