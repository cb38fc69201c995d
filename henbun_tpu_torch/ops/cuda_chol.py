"""Batched lower Cholesky of small float32 matrices: the hand-written CUDA
kernel ``csrc/chol128.cu`` (K1), its plain PyTorch version and its launch
counter.

Replaces the TPU kernel ``henbun_tpu/ops/pallas_chol.py``
``cholesky128_vbatched`` (body ``_chol_kernel_vbatch``). On the card the
kernel runs one thread block per matrix with the lower triangle in shared
memory; what bounds it at the training path's shapes (B = 16, n = 40) is
its n-step barrier chain and the launch latency, not FLOPs or bytes (see
the source). ``safe_cholesky`` (``ops/linalg.py``) reaches it for every
batched float32 factorization with n <= 128 on a CUDA tensor while
``[cuda] use_kernels`` is on.

:func:`cholesky128_vbatched` takes the kernel for a CUDA tensor and the
plain version for a CPU tensor, and raises on anything else; nothing falls
back. ``cholesky128_vbatched.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 128
# chol128_launch(A, L, batch, n, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def cholesky128_plain(A):
    """The kernel's arithmetic as a column loop on tensors: right-looking,
    reads only the lower triangle, zeros above the diagonal, an all-NaN
    factor for a matrix whose pivot is not positive (or NaN)."""
    n = A.shape[-1]
    L = torch.tril(A).clone()
    failed = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(n):
        d = L[..., j, j]
        ok = d > 0
        failed |= ~ok
        piv = torch.sqrt(torch.where(ok, d, torch.ones_like(d)))
        L[..., j, j] = piv
        col = L[..., j + 1 :, j] / piv[..., None]
        L[..., j + 1 :, j] = col
        L[..., j + 1 :, j + 1 :] -= torch.tril(col[..., :, None] * col[..., None, :])
    return torch.where(failed[..., None, None], float("nan"), L)


def _check(A):
    if not isinstance(A, torch.Tensor):
        raise TypeError("cholesky128_vbatched takes a tensor")
    if A.dtype != torch.float32:
        raise TypeError("cholesky128_vbatched takes float32, got %s" % A.dtype)
    if A.ndim != 3 or A.shape[-1] != A.shape[-2] or not 0 < A.shape[-1] <= MAX_N:
        raise ValueError(
            "cholesky128_vbatched needs [B, n, n] with 0 < n <= %d; got %s"
            % (MAX_N, tuple(A.shape))
        )
    if not A.is_contiguous():
        raise ValueError("cholesky128_vbatched needs a contiguous tensor")


def cholesky128_vbatched(A):
    """Lower Cholesky factor of each matrix of a [B, n, n] float32 batch,
    n <= 128: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check(A)
    if A.device.type == "cpu":
        return cholesky128_plain(A)
    if A.device.type != "cuda":
        raise ValueError("cholesky128_vbatched runs on CUDA or CPU, not %s" % A.device)
    L = torch.empty_like(A)
    if A.shape[0] == 0:
        return L
    fn = _build.load("chol128", "chol128_launch", _ARGTYPES)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), L.data_ptr(), A.shape[0], A.shape[-1], stream)
    if err != 0:
        raise RuntimeError("chol128 kernel launch failed: cudaError %d" % err)
    cholesky128_vbatched.launches += 1
    return L


cholesky128_vbatched.launches = 0
