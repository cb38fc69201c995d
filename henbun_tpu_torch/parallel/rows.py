"""Sums over the rows of a full-batch objective, for row-sharded steps.

The sparse evidence engines (``inference/laplace.py``'s generic Newton
loop and its evidence, its softmax engine, ``inference/ep.py``'s
projected EP) see the data only through sums over its rows:
sum_i loglik_i, A^T g, A^T W A, A^T T A, A^T nu, the site terms, and
the softmax engine's A^T G and the Grams G^T G and Gi^T Gi of its
square-root curvature factor. Everything else is m x m (Km x Km) algebra built
from those sums, or a per-row quantity (a site, a marginal) that only its
own row reads. So when the rows are split over ranks, each rank can keep
a contiguous block of them, take its partial sums, and all-reduce them;
the m x m algebra that follows is then replicated, and every host
decision taken on it (``safe_cholesky``'s NaN flag, the Newton ladder,
the EP guard) comes out alike on every rank.

:class:`~henbun_tpu_torch.parallel.ShardedOptimizer` does this for an
objective declared with :func:`row_sharded` and trained full-batch: it
runs the step inside :func:`sharded_rows`, where :func:`row_sum` and
:func:`row_max` are all-reduces over the mesh's ``data`` group. Anywhere
else (one process, a fleet, an objective that has not opted in) both are
the identity.

The gradient. Rank r computes the one-process objective L from its own
rows: L = G(theta, S) with S = sum_r s_r(theta) the all-reduced row sums
and G everything replicated. The all-reduce y_r = sum_s x_s (for every r)
is self-adjoint: its backward all-reduces the incoming gradients,
xbar_s = sum_r ybar_r. So when every rank seeds its own copy L_r with 1
and runs backward, the ranks together compute the gradient of
sum_r L_r = n L with respect to each rank's copy theta_r of the shared
parameters, and sum_r (rank r's gradient) = n dL/dtheta. Rank r's
gradient is dG/dtheta (the replicated terms, once) + n dG/dS ds_r/dtheta
(its rows, weighted by every rank's cotangent); the mean over ranks that
``ShardedOptimizer._reduce_step`` takes gives dG/dtheta x 1 for the
replicated terms and dG/dS sum_r ds_r/dtheta for the rows: each row
summed once, exactly the one-process gradient. The objective itself is
the same on every rank, and so is its mean.

An ``autograd.Function`` that takes its row sums inside its forward
(where autograd does not see :class:`_RowSum`) keeps
:func:`current_group` and gives its backward the same weights: it
all-reduces the cotangent that meets its rows, as ``_RowSum.backward``
would (the softmax engine's ``LogdetSqrtGram`` sums its lambda, the IFT
backward of ``SoftmaxModeImplicit`` its solve w).

Every call is counted (:data:`stats`): the all-reduces a step and their
bytes, forward and backward, which depend on m and the iteration counts
and not on n.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_GROUP = []   # the process group of the row-sharded step being evaluated
stats = {"calls": 0, "bytes": 0}


def row_sharded(method):
    """Declare an objective a function of row sums only (every contraction
    over the rows goes through :func:`row_sum`), so that
    ``ShardedOptimizer`` may split its full batch over the ``data``
    ranks. Put it under ``@AutoOptimize()``."""
    method.henbun_row_sharded = True
    return method


def is_row_sharded(method):
    return bool(getattr(method, "henbun_row_sharded", False))


@contextlib.contextmanager
def sharded_rows(group):
    """Inside: row_sum and row_max reduce over `group`'s ranks (with None
    they stay the identity)."""
    _GROUP.append(group)
    try:
        yield
    finally:
        _GROUP.pop()


def current_group():
    """The group of the row-sharded step being evaluated, or None. An
    ``autograd.Function`` that sums rows inside its forward keeps it for
    its backward, which re-enters :func:`sharded_rows` with it."""
    return _GROUP[-1] if _GROUP else None


def reset_stats():
    stats.update(calls=0, bytes=0)


def _all_reduce(flat, group, op=dist.ReduceOp.SUM):
    stats["calls"] += 1
    stats["bytes"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat, op=op, group=group)
    return flat


class _RowSum(torch.autograd.Function):
    """All-reduce (sum) of a flat buffer; its backward all-reduces the
    incoming gradient (the module docstring)."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return _all_reduce(flat.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


def row_sum(*parts):
    """The sums over every rank's rows of this rank's partial sums
    `parts` (tensors of any shapes), as one all-reduce; the identity
    outside a row-sharded step. Returns a tensor for one part, else a
    tuple."""
    group = current_group()
    if group is not None:
        flat = _RowSum.apply(torch.cat([p.reshape(-1) for p in parts]), group)
        out, off = [], 0
        for p in parts:
            out.append(flat[off:off + p.numel()].reshape(p.shape))
            off += p.numel()
        parts = tuple(out)
    return parts[0] if len(parts) == 1 else parts


def row_max(x):
    """The largest of every rank's `x` (a diagnostic; no gradient); the
    identity outside a row-sharded step."""
    group = current_group()
    if group is None:
        return x
    return _all_reduce(x.detach().reshape(-1).clone(), group,
                       dist.ReduceOp.MAX).reshape(x.shape)
