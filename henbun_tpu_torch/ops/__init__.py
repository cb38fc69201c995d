"""Numeric ops: ``linalg`` (helpers, ``safe_cholesky``, ``tri_solve``),
``quadrature``, ``blocked`` (blocked Cholesky and triangular solve for
large single matrices) and the hand-written CUDA kernels (``cuda_chol``,
``cuda_solve`` behind linalg; ``cuda_newton``, the Laplace Newton loop;
``cuda_wide``, the wide-right-hand-side solves), and ``library``, which
registers K1 and K2 as the custom ops ``henbun_tpu_torch::cholesky128``
and ``henbun_tpu_torch::tri_solve128`` that linalg dispatches to."""
from . import library, linalg, cuda_chol, cuda_solve, cuda_newton, cuda_wide, blocked, quadrature
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
    tri_solve_T,
)
