"""K1 and K2 as ``torch.library`` custom ops, so that ``torch.export`` can
trace a program that reaches them (it cannot trace a ctypes launch).

* ``henbun_tpu_torch::cholesky128(A)``: the lower Cholesky factor of each
  matrix of a [B, n, n] float32 batch, n <= 128, all NaN where a pivot
  fails. CUDA: K1's kernel (``cuda_chol.cholesky128_vbatched``); CPU: its
  plain version.
* ``henbun_tpu_torch::tri_solve128(L, R, transpose)``: X with L X = R (or
  L^T X = R) for [B, n, n] factors and a [B, n, m] right-hand side. The
  width m is decided here, at run time: K2 (``cuda_solve``) on CUDA, or
  its plain version on the CPU, where m <= 128; ``torch.linalg
  .solve_triangular`` past that. An exported program whose request size
  is the symbolic m therefore serves any size without a guard on it.

Each op has a fake (shape) rule for tracing and a vmap rule that folds
the vmapped dimension into the op's batch. ``ops/linalg.py``'s dispatch
reaches the kernels only through these ops, so a training step and an
exported program launch the same kernel, counted on the same wrapper.
Importing this module registers the ops; an exported program that holds
them loads only after it (``henbun_tpu_torch.serving`` imports it).
"""
from __future__ import annotations

import torch

from . import cuda_chol, cuda_solve

# ----------------------------------------------------------------- cholesky


@torch.library.custom_op("henbun_tpu_torch::cholesky128", mutates_args=(),
                         device_types="cpu")
def cholesky128(A: torch.Tensor) -> torch.Tensor:
    """K1's plain version (a CPU tensor)."""
    return cuda_chol.cholesky128_vbatched(A.contiguous())


@cholesky128.register_kernel("cuda")
def _cholesky128_cuda(A):
    return cuda_chol.cholesky128_vbatched(A.contiguous())


@cholesky128.register_fake
def _cholesky128_fake(A):
    return A.new_empty(A.shape)


@cholesky128.register_vmap
def _cholesky128_vmap(info, in_dims, A):
    A = A.movedim(in_dims[0], 0)
    return cholesky128(A.reshape((-1,) + tuple(A.shape[-2:]))).reshape(A.shape), 0


# -------------------------------------------------------------- tri_solve


def _solve(L, R, transpose):
    if 0 < R.shape[-1] <= cuda_solve.MAX_N:
        return cuda_solve.tri_solve128_vbatched(L.contiguous(), R.contiguous(),
                                                transpose=transpose)
    if transpose:
        X = torch.linalg.solve_triangular(L.mT, R, upper=True)
    else:
        X = torch.linalg.solve_triangular(L, R, upper=False)
    return X.contiguous()


@torch.library.custom_op("henbun_tpu_torch::tri_solve128", mutates_args=(),
                         device_types="cpu")
def tri_solve128(L: torch.Tensor, R: torch.Tensor, transpose: bool) -> torch.Tensor:
    """K2's plain version for m <= 128 (CPU tensors), else torch.linalg."""
    return _solve(L, R, transpose)


@tri_solve128.register_kernel("cuda")
def _tri_solve128_cuda(L, R, transpose):
    return _solve(L, R, transpose)


@tri_solve128.register_fake
def _tri_solve128_fake(L, R, transpose):
    return R.new_empty(R.shape)


@tri_solve128.register_vmap
def _tri_solve128_vmap(info, in_dims, L, R, transpose):
    size = info.batch_size
    L = L.movedim(in_dims[0], 0) if in_dims[0] is not None else L.expand((size,) + L.shape)
    R = R.movedim(in_dims[1], 0) if in_dims[1] is not None else R.expand((size,) + R.shape)
    n, m = L.shape[-1], R.shape[-1]
    X = tri_solve128(L.reshape(-1, n, n), R.reshape(-1, n, m), transpose)
    return X.reshape(R.shape), 0
