"""Batched triangular solves against small float32 factors: the hand-written
CUDA kernel ``csrc/trisolve128.cu`` (K2), its plain PyTorch version and its
launch counter.

Replaces the TPU kernel ``henbun_tpu/ops/pallas_solve.py``
``tri_solve128_vbatched`` (bodies ``_lsolve_kernel_vbatch`` and
``_usolve_kernel_vbatch``) in both modes: ``transpose=False`` solves
L X = R by forward substitution, ``transpose=True`` solves L^T X = R by back
substitution. Only L's lower triangle is read in either mode. On the card
the kernel runs one thread block per matrix with the factor and the
solution in shared memory, blocked over 32-row diagonal blocks: a thread
a right-hand column solves each diagonal block, then all threads update
the rows still open with a register-tiled product, so every thread works
even at m = 1. Each column's chain of n divides and the barriers between
blocks bound it, not FLOPs or bytes (see the source). ``ops/linalg.py``
reaches it for batched float32 solves with
n, m <= 128 on CUDA tensors while ``[cuda] use_kernels`` is on, through the
custom op ``henbun_tpu_torch::tri_solve128`` (``ops/library.py``, which
decides m at run time): the forward and gradient solves of ``tri_solve``
and both L^T solves of ``safe_cholesky``'s backward.

:func:`tri_solve128_vbatched` takes the kernel for CUDA tensors and the
plain version for CPU tensors, and raises on anything else; nothing falls
back. ``tri_solve128_vbatched.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 128
# trisolve128_launch(L, R, X, batch, n, m, transpose, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def tri_solve128_plain(L, R, transpose=False):
    """The kernel's arithmetic as a row loop on tensors, reading only L's
    lower triangle: forward substitution for L X = R, back substitution
    (on L[k, i], k > i) for L^T X = R."""
    n = L.shape[-1]
    X = torch.empty_like(R)
    rows = reversed(range(n)) if transpose else range(n)
    for i in rows:
        if transpose:
            coef, done = L[..., i + 1 :, i], X[..., i + 1 :, :]
        else:
            coef, done = L[..., i, :i], X[..., :i, :]
        acc = R[..., i, :] - torch.einsum("...k,...km->...m", coef, done)
        X[..., i, :] = acc / L[..., i, i, None]
    return X


def _check(L, R):
    for name, t in (("L", L), ("R", R)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("tri_solve128_vbatched takes tensors (%s)" % name)
        if t.dtype != torch.float32:
            raise TypeError("tri_solve128_vbatched takes float32, %s is %s" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("tri_solve128_vbatched needs contiguous tensors (%s)" % name)
    if L.ndim != 3 or L.shape[-1] != L.shape[-2] or not 0 < L.shape[-1] <= MAX_N:
        raise ValueError(
            "need [B, n, n] triangular factors with 0 < n <= %d; got %s"
            % (MAX_N, tuple(L.shape))
        )
    B, n = L.shape[0], L.shape[-1]
    if R.ndim != 3 or R.shape[0] != B or R.shape[1] != n or not 0 < R.shape[2] <= MAX_N:
        raise ValueError(
            "rhs must be [B=%d, n=%d, m] with 0 < m <= %d; got %s"
            % (B, n, MAX_N, tuple(R.shape))
        )
    if L.device != R.device:
        raise ValueError("L on %s, rhs on %s" % (L.device, R.device))


def tri_solve128_vbatched(L, R, transpose=False):
    """X with L X = R (``transpose=False``) or L^T X = R
    (``transpose=True``) for each lower-triangular [n, n] factor of a
    [B, n, n] float32 batch against a [B, n, m] right-hand side,
    n, m <= 128: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _check(L, R)
    if L.device.type == "cpu":
        return tri_solve128_plain(L, R, transpose)
    if L.device.type != "cuda":
        raise ValueError("tri_solve128_vbatched runs on CUDA or CPU, not %s" % L.device)
    X = torch.empty_like(R)
    if L.shape[0] == 0:
        return X
    fn = _build.load("trisolve128", "trisolve128_launch", _ARGTYPES)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = fn(L.data_ptr(), R.data_ptr(), X.data_ptr(), L.shape[0],
                 L.shape[-1], R.shape[-1], int(bool(transpose)), stream)
    if err != 0:
        raise RuntimeError("trisolve128 kernel launch failed: cudaError %d" % err)
    tri_solve128_vbatched.launches += 1
    return X


tri_solve128_vbatched.launches = 0
