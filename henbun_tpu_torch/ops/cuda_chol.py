"""Lower Cholesky of small float32 matrices: the hand-written CUDA kernel
``csrc/chol128.cu`` behind three entry points, its plain PyTorch version
and a launch counter on each entry.

The kernel replaces three TPU kernels of ``henbun_tpu/ops/pallas_chol.py``
that compute the same factorization and differ only in how Mosaic lays the
batch into VMEM:

* :func:`cholesky128_vbatched` (K1), for ``cholesky128_vbatched``: the
  whole batch in one block (body ``_chol_kernel_vbatch``);
* :func:`cholesky128_batched` (K5), for ``cholesky128_batched``: a grid
  with one cell per matrix (body ``_chol_kernel``);
* :func:`cholesky128` (K4), for ``cholesky128``: one tile.

On the card one thread block factors one matrix, held in shared memory,
so K1's grid over the batch already is K5's grid, and K4 is its B = 1
case; the three entries share one launch and no copy of the kernel's
body. The kernel is a blocked right-looking Cholesky over 32-column
panels: one warp factors each diagonal block with shuffles, the rows below
it are solved a thread a row, and all threads apply a register-tiled
trailing update, three block barriers a panel. What bounds it is that
chain of pivots (a square root and a divide each) and the barriers, not
FLOPs or bytes (see the source). ``safe_cholesky`` (``ops/linalg.py``)
reaches K1 for every batched float32 factorization with n <= 128 on a CUDA
tensor while ``[cuda] use_kernels`` is on, through the custom op
``henbun_tpu_torch::cholesky128`` (``ops/library.py``), which an exported
program calls too; K4 and K5, like their TPU counterparts, are reached by
direct import only.

Each entry takes the kernel for a CUDA tensor and the plain version for a
CPU tensor, and raises on anything else; nothing falls back. Its
``.launches`` counts the kernel launches made through it.
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


def _factor(A, entry):
    """Factor a checked [B, n, n] float32 contiguous batch through `entry`:
    the plain version on the CPU, one kernel launch (counted on `entry`)
    on CUDA."""
    if A.device.type == "cpu":
        return cholesky128_plain(A)
    if A.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU, not %s" % (entry.__name__, A.device))
    L = torch.empty_like(A)
    if A.shape[0] == 0:
        return L
    fn = _build.load("chol128", "chol128_launch", _ARGTYPES)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), L.data_ptr(), A.shape[0], A.shape[-1], stream)
    if err != 0:
        raise RuntimeError("chol128 kernel launch failed: cudaError %d" % err)
    entry.launches += 1
    return L


def cholesky128_vbatched(A):
    """Lower Cholesky factor of each matrix of a [B, n, n] float32 batch,
    n <= 128: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check(A)
    return _factor(A, cholesky128_vbatched)


def _as_float32(A, name):
    """The reference computes in float32 whatever it is given."""
    if not isinstance(A, torch.Tensor):
        raise TypeError("%s takes a tensor" % name)
    return A.to(torch.float32).contiguous()


def cholesky128_batched(A):
    """Lower Cholesky factor of each matrix of a [B, n, n] batch, n <= 128,
    computed in float32 (K5; any B): an all-NaN factor for each matrix that
    is not positive definite, the others untouched. The CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    A = _as_float32(A, "cholesky128_batched")
    n = A.shape[-1]
    if A.ndim != 3 or A.shape[-2] != n or not 0 < n <= MAX_N:
        raise ValueError(
            "cholesky128_batched needs [B, n, n] with n <= 128; got %s" % (tuple(A.shape),)
        )
    return _factor(A, cholesky128_batched)


def cholesky128(A):
    """Lower Cholesky factor of one [n, n] matrix, n <= 128, computed in
    float32 (K4): all NaN when it is not positive definite. Only the lower
    triangle is read. The CUDA kernel (one block) on a CUDA tensor, the
    plain version on a CPU tensor."""
    A = _as_float32(A, "cholesky128")
    n = A.shape[-1]
    if A.ndim != 2 or A.shape[-2] != n or not 0 < n <= MAX_N:
        raise ValueError("cholesky128 needs a square matrix with n <= 128")
    return _factor(A[None], cholesky128)[0]


cholesky128_vbatched.launches = 0
cholesky128_batched.launches = 0
cholesky128.launches = 0
