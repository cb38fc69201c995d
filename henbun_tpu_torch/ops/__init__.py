"""Numeric ops: ``linalg`` (helpers, ``safe_cholesky``, ``tri_solve``) and
the hand-written CUDA kernels behind them (``cuda_chol``, ``cuda_solve``)."""
from . import linalg, cuda_chol, cuda_solve
from .linalg import (
    eye,
    clip,
    log_sum_exp,
    vec_to_tri,
    tri_to_vec,
    fill_triangular,
    fill_triangular_inverse,
    fill_triangular_diag_indices,
    matmul_hp,
    safe_cholesky,
    tri_solve,
)
