"""Numeric helper ops and the two linear-algebra Functions the models run
through: ``safe_cholesky`` and ``tri_solve``.

Dispatch (decided on shape inside each Function's ``forward``, which always
sees real tensors, also under ``torch.func.vmap``):

* a 3-D float32 batch with n <= 128 on a CUDA tensor, with ``[cuda]
  use_kernels`` on: the custom ops of ``ops/library.py``, whose CUDA
  implementations are the hand-written kernels (K1 ``ops/cuda_chol.py``,
  K2 ``ops/cuda_solve.py``); a solve's width m is decided inside the op,
  at run time (K2 where m <= 128, torch.linalg past it), so an exported
  program with a symbolic request size carries no guard on it;
* the same shapes on a CPU tensor: the same ops, whose CPU
  implementations are the kernels' plain PyTorch versions;
* anything else (a single 2-D matrix, n > 128, float64, CUDA with
  ``use_kernels`` off): ``torch.linalg``, as the JAX package sends such
  calls to XLA.

Under ``torch.func.vmap`` (a BatchedOptimizer fleet), each Function's
``vmap`` rule moves the batch dimension to the front, broadcasts an
unbatched operand, and calls the same Function on the 3-D tensors — the
counterpart of the JAX package's ``custom_vmap`` rules. The backward then
runs on those plain 3-D tensors, so its solves take the same dispatch.

Under ``torch.export`` the Functions are bypassed (a served program takes
no gradient): ``safe_cholesky`` runs its jitter escalation as a fixed
masked ladder instead of reading a flag to the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._settings import settings
from . import cuda_chol, library


def eye(n, dtype=None, device=None):
    """Identity matrix at the configured float type."""
    return torch.eye(n, dtype=dtype or settings.dtypes.float_type, device=device)


def clip(x):
    """Settings-gated value clipping against over/underflow; a no-op unless
    ``settings.numerics.clip_by_value``."""
    if settings.numerics.clip_by_value:
        return torch.clamp(
            x, settings.numerics.clip_value_min, settings.numerics.clip_value_max
        )
    return x


def log_sum_exp(x, axis=None):
    """Numerically stable log-sum-exp over `axis` (all axes when None)."""
    if axis is None:
        return torch.logsumexp(x.reshape(-1), dim=0)
    return torch.logsumexp(x, dim=axis)


@functools.lru_cache(maxsize=None)
def _tri_gather_map(n):
    """For the row-major triangle packing: at (i, j) of the flattened
    [n, n] matrix, the packed index stored there, or m (a zero slot) above
    the diagonal."""
    m = n * (n + 1) // 2
    out = np.full(n * n, m, np.int64)
    rows, cols = np.tril_indices(n)
    out[rows * n + cols] = np.arange(m)
    return out


def vec_to_tri(vec, n=None):
    """Pack the last axis (length n(n+1)/2) into an [n, n] lower-triangular
    matrix, row-major over the triangle. Leading axes are preserved. A
    gather (no in-place write), so it runs under vmap. The inverse of
    :func:`tri_to_vec`."""
    m = vec.shape[-1]
    if n is None:
        n = int((np.sqrt(8 * m + 1) - 1) / 2)
    if n * (n + 1) // 2 != m:
        raise ValueError("last axis %d is not a triangular number" % m)
    padded = torch.cat([vec, torch.zeros_like(vec[..., :1])], dim=-1)
    idx = torch.as_tensor(_tri_gather_map(n), device=vec.device)
    return padded[..., idx].reshape(vec.shape[:-1] + (n, n))


def tri_to_vec(mat):
    """Extract the lower triangle of the trailing [n, n] axes into a vector,
    row-major. The inverse of :func:`vec_to_tri`."""
    n = mat.shape[-1]
    if mat.shape[-2] != n:
        raise ValueError("trailing axes must be square, got %r" % (tuple(mat.shape),))
    rows, cols = np.tril_indices(n)
    dev = mat.device
    return mat[..., torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]


@functools.lru_cache(maxsize=None)
def _fill_triangular_layout(n):
    """Slot map of the fill-triangular packing: a probe vector 0..m-1 run
    through the concat/flip/reshape construction, giving at (i, j) the packed
    index stored there. Returns the packed positions of the diagonal and
    the (row, col) slot of each packed index (for the inverse gather)."""
    m = n * (n + 1) // 2
    probe = np.arange(m)
    mat = np.concatenate([probe[n:], probe[::-1]]).reshape(n, n)
    rows, cols = np.tril_indices(n)
    vec_index_at_slot = mat[rows, cols]
    inv_rows = np.empty(m, np.int64)
    inv_cols = np.empty(m, np.int64)
    inv_rows[vec_index_at_slot] = rows
    inv_cols[vec_index_at_slot] = cols
    diag = mat[np.arange(n), np.arange(n)].astype(np.int64)
    return diag, inv_rows, inv_cols


def fill_triangular_diag_indices(n):
    """Packed positions of the diagonal under the fill-triangular layout."""
    return _fill_triangular_layout(n)[0]


def fill_triangular(vec, n=None):
    """Pack the last axis (length n(n+1)/2) into an [n, n] lower-triangular
    matrix by the fill-triangular construction (concat the tail with the
    reversed vector, reshape, mask): pure data movement. The entry ORDER
    within the triangle differs from :func:`vec_to_tri`'s row-major one; use
    :func:`fill_triangular_inverse` / :func:`fill_triangular_diag_indices`
    to address entries. Leading axes are preserved."""
    m = vec.shape[-1]
    if n is None:
        n = int((np.sqrt(8 * m + 1) - 1) / 2)
    if n * (n + 1) // 2 != m:
        raise ValueError("last axis %d is not a triangular number" % m)
    x = torch.cat([vec[..., n:], torch.flip(vec, dims=[-1])], dim=-1)
    return torch.tril(x.reshape(vec.shape[:-1] + (n, n)))


def fill_triangular_inverse(mat):
    """Packed vector such that ``fill_triangular(vec) == tril(mat)``."""
    n = mat.shape[-1]
    if mat.shape[-2] != n:
        raise ValueError("trailing axes must be square, got %r" % (tuple(mat.shape),))
    _, rows, cols = _fill_triangular_layout(n)
    dev = mat.device
    return mat[..., torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]


def matmul_hp(a, b):
    """Matrix product at full float32 precision: TF32 is off under
    ``[cuda] matmul_precision = highest`` (set when a Model resolves its
    device), which a gram feeding a Cholesky needs."""
    return torch.matmul(a, b)


# --------------------------------------------------------------- dispatch
def _kernel_shape(A, R=None):
    """Is this a call the custom ops take? Only static facts are read (a
    solve's width is the op's own decision), so an exported program adds
    no guard on a symbolic request size."""
    if A.ndim != 3 or A.dtype != torch.float32:
        return False
    n = A.shape[-1]
    if A.shape[-2] != n or not 0 < n <= cuda_chol.MAX_N:
        return False
    if R is None:
        return True
    return (
        R.ndim == 3
        and R.dtype == torch.float32
        and R.shape[0] == A.shape[0]
        and R.shape[1] == n
    )


def _takes_kernel(A, R=None):
    """Does this call go to the K1/K2 custom op (the kernel on CUDA, its
    plain version on the CPU)? If not, it goes to torch.linalg."""
    if not _kernel_shape(A, R):
        return False
    dev = A.device.type
    return dev == "cpu" or (dev == "cuda" and bool(settings.cuda.use_kernels))


def _cholesky_dispatch(A):
    """Lower Cholesky factor with an all-NaN factor for each matrix that is
    not positive definite (as ``jnp.linalg.cholesky``)."""
    if _takes_kernel(A):
        return library.cholesky128(A)
    # cholesky_ex leaves a partial factor where a pivot fails; write NaN
    # over each failed matrix, or the jitter escalation never triggers
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def _tri_solve_dispatch(L, R, transpose):
    """X with L X = R (or L^T X = R), reading only L's lower triangle."""
    if _takes_kernel(L, R):
        return library.tri_solve128(L, R, bool(transpose))
    if transpose:
        return torch.linalg.solve_triangular(L.mT, R, upper=True)
    return torch.linalg.solve_triangular(L, R, upper=False)


def _to_front(x, dim, size):
    """Move a vmapped operand's batch dim to the front, or broadcast an
    unbatched one to `size`."""
    if dim is None:
        return x.expand((size,) + tuple(x.shape))
    return x.movedim(dim, 0)


class SafeCholesky(torch.autograd.Function):
    """Lower Cholesky of A + jitter*I with NaN-retry jitter escalation and
    the Murray backward.

    Forward: factorize A + jitter*I; each matrix whose factor has NaN is
    refactorized with its jitter x100, at most twice. Only failing matrices
    escalate, each on its own (what the JAX package's masked ``while_loop``
    does under vmap). The ``any()`` that decides whether to retry reads one
    flag back to the host per factorization.

    Backward (Murray 2016): Abar = 0.5 (S + S^T) with
    S = L^-T (c * (L^T Lbar)) L^-1, c the lower mask with the diagonal
    halved; both L^T solves take the solve dispatch.
    """

    @staticmethod
    def forward(A, jitter):
        return escalating_cholesky(A, jitter)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        n = L.shape[-1]
        c = torch.tril(torch.ones(n, n, dtype=L.dtype, device=L.device))
        c = c - 0.5 * torch.eye(n, dtype=L.dtype, device=L.device)
        Y = c * matmul_hp(L.mT, Lbar)
        Z = _tri_solve_dispatch(L, Y, True)  # L^-T Y
        W = _tri_solve_dispatch(L, Z.mT, True)  # S^T = L^-T Z^T
        return 0.5 * (W + W.mT), None

    @staticmethod
    def vmap(info, in_dims, A, jitter):
        if in_dims[0] is None:
            return SafeCholesky.apply(A, jitter), None
        return SafeCholesky.apply(A.movedim(in_dims[0], 0), jitter), 0


class TriSolve(torch.autograd.Function):
    """X = L^-1 R (or L^-T R with ``transpose``) for lower-triangular L,
    reading only L's lower triangle. Backward: Rbar = L^-T Xbar and
    Lbar = -tril(Rbar X^T); transposed, Rbar = L^-1 Xbar and
    Lbar = -tril(X Rbar^T) (the cotangent of L lands in its lower triangle
    only)."""

    @staticmethod
    def forward(L, R, transpose):
        return _tri_solve_dispatch(L, R, transpose)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.transpose = inputs[2]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        Rbar = _tri_solve_dispatch(L, Xbar, not ctx.transpose)
        if ctx.transpose:
            Lbar = -torch.tril(matmul_hp(X, Rbar.mT))
        else:
            Lbar = -torch.tril(matmul_hp(Rbar, X.mT))
        return Lbar, Rbar, None

    @staticmethod
    def vmap(info, in_dims, L, R, transpose):
        size = info.batch_size
        return TriSolve.apply(
            _to_front(L, in_dims[0], size), _to_front(R, in_dims[1], size), transpose
        ), 0


def escalating_cholesky(A, jitter, read_host=True):
    """Lower Cholesky of A + jitter*I, each matrix whose factor has NaN
    refactorized with its jitter x100, at most twice; a rung replaces only
    the matrices still NaN, as the JAX package's masked ``while_loop``
    does. ``read_host`` stops the ladder once no factor is NaN, one flag
    read back a rung; without it (a traced, exported program) both rungs
    always run: the same factor at three factorizations a call, or once in
    all where the matrix is frozen state (``serving`` folds it)."""
    n = A.shape[-1]
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)
    L = _cholesky_dispatch(A + jitter * eye_n)
    j = jitter
    for _ in range(2):
        bad = torch.isnan(L).flatten(-2).any(-1)
        if read_host and not bool(bad.any()):
            break
        j = j * 100.0
        L = torch.where(bad[..., None, None], _cholesky_dispatch(A + j * eye_n), L)
    return L


def safe_cholesky(A, jitter=None):
    """Lower Cholesky of A + jitter*I (default ``[numerics] jitter_level``),
    escalating the jitter x100 (twice, per matrix) where the factor is NaN;
    see :class:`SafeCholesky` (the ladder without its host read under
    ``torch.export``)."""
    if jitter is None:
        jitter = settings.numerics.jitter_level
    if torch.compiler.is_exporting():
        return escalating_cholesky(A, float(jitter), read_host=False)
    return SafeCholesky.apply(A, float(jitter))


def tri_solve(L, R):
    """X = L^-1 R for lower-triangular L (a vector R is solved as one
    column); see :class:`TriSolve`."""
    if R.ndim == L.ndim - 1:
        return tri_solve(L, R[..., None])[..., 0]
    if torch.compiler.is_exporting():
        return _tri_solve_dispatch(L, R, False)
    return TriSolve.apply(L, R, False)


def tri_solve_T(L, R):
    """X = L^-T R for lower-triangular L, reading only its lower triangle;
    see :class:`TriSolve`."""
    if torch.compiler.is_exporting():
        return _tri_solve_dispatch(L, R, True)
    return TriSolve.apply(L, R, True)
