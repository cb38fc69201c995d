"""Blocked Cholesky and triangular solve for large single float32 matrices
(n a multiple of 128), the port of ``henbun_tpu/ops/blocked.py``.

The exact-gram evidence paths (``GPRMarginal``) are the library's one
compute-bound family: one [n, n] factorization a step, plus the two
[n, n]-right-hand-side triangular solves of its Murray backward. Both
functions here are right-looking loops over 128-blocks: the O(n^3) terms
are float32 matrix products (:func:`~.linalg.matmul_hp`, TF32 off), and
the serial substitution is confined to 128-row diagonal solves:

* :func:`blocked_cholesky`: each diagonal block goes to
  ``torch.linalg.cholesky_ex`` (NaN written over a failed block, as the
  reference's ``jnp.linalg.cholesky``, so NaN reaches the factor); the
  symmetry of the trailing matrix gives the panel's right-hand side A21^T
  as the row slice T[:128, 128:]; each Schur update is one product on the
  shrinking remainder.
* :func:`blocked_tri_solve`: forward (L X = B) or transposed (L^T X = B)
  substitution over 128-row blocks, one diagonal solve and one product
  a block.

Diagonal solves (:func:`_diag_solve`) against a [128, m] panel with m a
multiple of 128 and at most 64 such chunks put the chunks on a batch axis,
as the reference does on the TPU, and take the solve dispatch of
``ops/linalg.py``: K2 (``cuda_solve.tri_solve128_vbatched``) on a CUDA
tensor while ``[cuda] use_kernels`` is on, its plain version on a CPU
tensor. Other panels go to ``torch.linalg.solve_triangular``.

A measured experiment, as in the reference: ``safe_cholesky`` does not
dispatch here; call these functions directly.
"""
from __future__ import annotations

import torch

from .._settings import apply_matmul_precision
from .linalg import _cholesky_dispatch, _tri_solve_dispatch, matmul_hp

NB = 128
MAX_CHUNKS = 64


def _diag_solve(L128, Bwide, transpose):
    """X [128, m] with L128 X = Bwide (or L128^T X = Bwide) for a lower
    [128, 128] factor, reading only its lower triangle. With m a multiple
    of 128 and at most 64 chunks, the 128-column chunks go on a batch axis
    against copies of the one factor (K2's shape); a 2-D panel goes to
    torch.linalg."""
    m = Bwide.shape[-1]
    if m % NB == 0 and 0 < m // NB <= MAX_CHUNKS:
        nc = m // NB
        chunks = Bwide.reshape(NB, nc, NB).transpose(0, 1)
        X = _tri_solve_dispatch(L128.expand(nc, NB, NB), chunks, transpose)
        return X.transpose(0, 1).reshape(NB, m)
    return _tri_solve_dispatch(L128, Bwide, transpose)


def _check_blocks(L, name):
    n = L.shape[-1]
    if L.ndim != 2 or L.shape[0] != n or n == 0 or n % NB:
        raise ValueError("%s needs one [n, n] matrix with n a multiple of %d; got %s"
                         % (name, NB, tuple(L.shape)))
    return n // NB


def blocked_cholesky(A):
    """Lower Cholesky factor of one [n, n] SPD matrix, n a multiple of 128.
    A diagonal block that is not positive definite turns to NaN and the NaN
    runs on through the rest of the factor, as with
    ``jnp.linalg.cholesky``, so a jitter escalation composes with it."""
    nblk = _check_blocks(A, "blocked_cholesky")
    apply_matmul_precision()
    T = A
    cols = []
    for j in range(nblk):
        parts = [A.new_zeros(j * NB, NB), _cholesky_dispatch(T[:NB, :NB])]
        if j < nblk - 1:
            # symmetry: A21^T is the row slice T[:128, 128:]
            L21T = _diag_solve(parts[1], T[:NB, NB:], False)  # [128, R]
            L21 = L21T.mT  # [R, 128]
            T = T[NB:, NB:] - matmul_hp(L21, L21T)
            parts.append(L21)
        cols.append(torch.cat(parts, dim=0))
    return torch.cat(cols, dim=1)


def blocked_tri_solve(L, B, transpose=False):
    """X with L X = B (or L^T X = B) for one lower-triangular [n, n] L and
    an [n, m] B, n a multiple of 128: one diagonal solve and one product
    correcting the rows still open, a 128-row block at a time."""
    nblk = _check_blocks(L, "blocked_tri_solve")
    if B.ndim != 2 or B.shape[0] != L.shape[0]:
        raise ValueError("rhs must be [n=%d, m]; got %s" % (L.shape[0], tuple(B.shape)))
    apply_matmul_precision()
    outs = [None] * nblk
    Bcur = B
    if not transpose:
        for j in range(nblk):
            j0, j1 = j * NB, (j + 1) * NB
            outs[j] = _diag_solve(L[j0:j1, j0:j1], Bcur[:NB], False)
            if j < nblk - 1:
                Bcur = Bcur[NB:] - matmul_hp(L[j1:, j0:j1], outs[j])
    else:
        for j in reversed(range(nblk)):
            j0, j1 = j * NB, (j + 1) * NB
            outs[j] = _diag_solve(L[j0:j1, j0:j1], Bcur[j0:], True)
            if j > 0:
                Bcur = Bcur[:j0] - matmul_hp(L[j0:j1, :j0].mT, outs[j])
    return torch.cat(outs, dim=0)
