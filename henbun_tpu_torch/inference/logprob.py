"""Vectorized log-probability: model objective -> flat density.

Compile the Parameterized model tree used for VI into a pure
``log_prob(theta)`` over a flat unconstrained vector, for HMC, NUTS, ChEES
and SMC. Transform log-Jacobians of constrained Variables are added, so the
samplers run in free space but target the constrained-space posterior
(change of variables).

``log_prob`` takes one theta [dim]; the samplers evaluate a batch of chains
[C, dim] with :func:`batched_value_and_grad`: ``torch.func.vmap`` over the
chains (the parameter dicts go through the trace context as in
``BatchedOptimizer``, so the factorizations and solves inside see the
whole batch through their vmap rules), and the per-chain gradients from
one backward pass of the summed chains, exact because the chains are
independent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import context as _ctx
from ..core.param import graph_key
from ..model import _resolve_method


@dataclass
class FlatLogProb:
    """A flat view of a model's log density over a parameter collection.

    Attributes:
      log_prob: theta [dim] -> scalar log density (vmap-safe)
      dim: flat dimension
      paths / shapes: the tree paths and shapes theta concatenates
      initial: the model's current free values, flattened [dim]
    """

    log_prob: Callable
    dim: int
    paths: list
    shapes: list
    initial: torch.Tensor
    _model: object = None
    _collection: object = None

    def unravel(self, theta):
        """{path: free-space tensor} of a flat theta [dim]."""
        out = {}
        off = 0
        for path, shape in zip(self.paths, self.shapes):
            size = int(np.prod(shape)) if len(shape) else 1
            out[path] = torch.reshape(theta[off:off + size], shape)
            off += size
        return out

    def ravel(self, params):
        """The flat theta [dim] of a {path: free-space value} dict."""
        return torch.cat([torch.as_tensor(params[p]).reshape(-1) for p in self.paths])

    def set_model_state(self, theta):
        """Write a flat sample back into the model tree (free space)."""
        theta = torch.as_tensor(theta)
        self._model.set_param_dict(
            {k: v.detach().cpu().numpy() for k, v in self.unravel(theta).items()}
        )


def make_log_prob(model, method, collection=None, add_transform_jacobians=True,
                  minibatch_index=None):
    """Build a :class:`FlatLogProb` from an objective method of `model`.

    - method: a raw method, an @AutoOptimize-decorated method, a method
      name, or an Optimizer; the body must return the log density.
    - collection: which Variables form theta; everything else is frozen at
      its current value.
    - add_transform_jacobians: include sum_i log|J_i| for the constrained
      Variables in the collection, so sampling in free space targets the
      constrained posterior.
    - minibatch_index: rows of every MinibatchData to keep (else all).

    The model must not contain unfed LOCAL variables on the traced path.
    """
    method = _resolve_method(model, method)
    model.initialize()
    target = model.param_dict(collection)
    frozen = model.param_dict(exclude=collection) if collection is not None else {}
    if len(target) == 0:
        raise ValueError("no variables in collection %r" % (collection,))
    paths = sorted(target.keys())
    shapes = [tuple(target[p].shape) for p in paths]
    sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
    dim = int(np.sum(sizes))
    initial = torch.cat([target[p].reshape(-1) for p in paths])
    data = model._gather_data(minibatch_index)
    transforms_by_path = {
        v.path_to(model): v.transform for v in model.get_variables(collection)
        if v.collections not in graph_key.not_parameters
    }
    # the evaluation's noise: the same generator state at every call (the
    # JAX package's fixed PRNGKey(0)); sampling targets draw none
    generator = torch.Generator(device=model.device)

    def log_prob(theta):
        params = dict(frozen)
        off = 0
        for path, shape, size in zip(paths, shapes, sizes):
            params[path] = torch.reshape(theta[off:off + size], shape)
            off += size
        generator.manual_seed(0)
        with _ctx.trace(model, params, data, generator):
            lp = method(model)
        if add_transform_jacobians:
            off = 0
            for path, shape, size in zip(paths, shapes, sizes):
                t = transforms_by_path.get(path)
                if t is not None:
                    lp = lp + torch.sum(
                        t.tf_log_jacobian(torch.reshape(theta[off:off + size], shape))
                    )
                off += size
        return lp

    return FlatLogProb(
        log_prob=log_prob, dim=dim, paths=paths, shapes=shapes, initial=initial,
        _model=model, _collection=collection,
    )


def batched_value_and_grad(log_prob):
    """theta [C, dim] -> (log_prob [C], d log_prob / d theta [C, dim]),
    detached: ``torch.func.vmap`` of `log_prob` over the chains and one
    backward pass of their sum. On a CUDA theta the evaluation is replayed
    from a captured CUDA graph when the target never synchronizes the host,
    and runs eagerly when it does (see :class:`CudaGraphed`)."""
    vlp = torch.func.vmap(log_prob, randomness="different")

    def vg(theta):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            lp = vlp(th)
            (g,) = torch.autograd.grad(torch.sum(lp), th)
        return lp.detach(), g

    return CudaGraphed(vg)


class CudaGraphed:
    """fn(theta) -> tuple of tensors, replayed from a CUDA graph captured at
    the first call with each theta shape: the hundreds of small launches of
    an eager evaluation become one replay, with theta copied into the
    graph's input and the outputs copied out. The same kernels run in the
    same order, so the results equal the eager ones.

    A graph cannot hold a host read (a retry flag read, a copy from host
    memory), so the first CUDA call decides, once for this fn: its first
    warm-up evaluation runs under ``torch.cuda``'s sync debug mode set to
    ``error``, and a target that synchronizes (``graphed`` False) runs
    eagerly from then on. A CPU theta always runs fn eagerly.
    ``replays`` counts the replays of every instance (one an evaluation)."""

    replays = 0

    def __init__(self, fn):
        self.fn = fn
        self.graphed = None  # decided at the first CUDA call
        self.graphs = {}

    def __call__(self, theta):
        if theta.device.type != "cuda" or self.graphed is False:
            return self.fn(theta)
        key = (tuple(theta.shape), theta.dtype, theta.device)
        if key not in self.graphs:
            static_in = theta.detach().clone()
            main = torch.cuda.current_stream(theta.device)
            side = torch.cuda.Stream(device=theta.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                # warm-up launches (library handles, autograd) off the graph
                if self.graphed is None:
                    self.graphed = not _synchronizes(self.fn, static_in)
                if self.graphed:
                    self.fn(static_in)
            main.wait_stream(side)
            if not self.graphed:
                return self.fn(theta)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self.fn(static_in)
            self.graphs[key] = (graph, static_in, static_out)
        graph, static_in, static_out = self.graphs[key]
        static_in.copy_(theta)
        graph.replay()
        CudaGraphed.replays += 1
        return tuple(o.clone() for o in static_out)


def _synchronizes(fn, theta):
    """Whether fn(theta) synchronizes the host: fn runs under the sync debug
    mode ``error``, which raises at the first synchronizing operation."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(theta)
    except RuntimeError as err:
        if "synchronizing" not in str(err):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(before)
    return False


def make_generator(generator, device):
    """A torch.Generator on `device`: the one given, or one seeded by the
    given int (0 when None)."""
    if isinstance(generator, torch.Generator):
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0 if generator is None else int(generator))
    return g
