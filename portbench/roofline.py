"""Operation and byte counts from shapes, and the card's peaks.

Every count is what the inputs need, not what a kernel happens to do: each
input byte read once, each output byte written once, and only the
arithmetic the result depends on. A kernel or a step that does more work
than counted reads a lower share, never one above 100%.

Peaks: one NVIDIA H100 SXM (the data sheet's dense rates): 3.35 TB/s of
HBM and 67 TFLOP/s of float32 outside the tensor cores. The
configurations keep ``matmul_precision = highest``, so TF32 is off and the
float32 peak is the one that applies.

K1's and K2's counts are those of ``chip_smoke.py`` (``chol_cost``,
``solve_cost``, ``bound``), frozen here so that the yardstick does not
move with the program.

A count that a later configuration needs and this file lacks goes in a
new file ``portbench/counts/<name>.py`` with a function ``flops(**shape)``;
:func:`step_flops` finds it by the name the configuration gives.
"""
from __future__ import annotations

import importlib.util
import os

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FLOAT32 = 4


def bound_s(nbytes, flops):
    """(seconds, what bounds it): the least time the card could take, the
    larger of bytes over the HBM rate and operations over the float32
    peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ one kernel call
def chol_cost(B, n):
    """K1 (or any batched Cholesky): bytes (the lower triangle read once,
    the factor written once) and operations (n square roots, the column
    divides, a multiply and a subtract per trailing update) of B
    factorizations of n x n."""
    nbytes = B * (n * (n + 1) // 2 + n * n) * FLOAT32
    flops = B * (n + n * (n - 1) // 2 + (n - 1) * n * (n + 1) // 3)
    return nbytes, flops


def solve_cost(B, n, m):
    """K2 (or any triangular solve): bytes (L's lower triangle, the
    right-hand side, the solution) and operations (n^2 per column) of B
    solves of n x n against n x m."""
    nbytes = B * (n * (n + 1) // 2 + 2 * n * m) * FLOAT32
    return nbytes, B * m * n * n


def potrf_cost(n):
    """One 2-D Cholesky (cuSOLVER's potrf): n^3/3 operations, the matrix's
    lower triangle read and the factor's written."""
    return n * (n + 1) * FLOAT32, n ** 3 // 3


def trsm_cost(n, k):
    """One 2-D triangular solve against n x k (cuBLAS's trsm): n^2 k
    operations; the triangle, the right-hand side and the solution."""
    return solve_cost(1, n, k)


# ----------------------------------------------------------- one whole step
def gpr_elbo_step(models, n):
    """Operations of one step of ``GPR.ELBO_gaussian`` (fullrank q, one
    input dimension) over a fleet, forward and backward, as the inputs need
    them:

    - forward: the gram's cross term (2 n^2) and exponential (n^2), its
      Cholesky (n^3/3), the triangular q sample and f = L q (n^2 each);
    - backward (Murray): the lower half of L^T Lbar, a product of two
      triangles (n^3/3), and two triangular solves against n columns
      (n^3 each).

    Elementwise terms of order n (the density, the KL) are left out: the
    count stays below the work done."""
    per_model = 5 * n * n + n ** 3 // 3 + n ** 3 // 3 + 2 * n ** 3
    return models * per_model


def gpr_exact_step(models, n):
    """Operations of one step of ``GPRMarginal.log_marginal``, forward and
    backward, as the inputs need them: the gram (3 n^2), its Cholesky
    (n^3/3), the solve against y (n^2); the Murray backward's lower half of
    L^T Lbar (n^3/3) and its two solves against n columns (n^3 each). The
    program's dense L^T Lbar product does 2 n^3, of which this counts the
    sixth the result needs."""
    per_model = 4 * n * n + n ** 3 // 3 + n ** 3 // 3 + 2 * n ** 3
    return models * per_model


def step_flops(name, **shape):
    """The step count named by a configuration's ``step_flops``: a function
    of this module, or ``flops`` of ``portbench/counts/<name>.py``."""
    fn = globals().get(name)
    if fn is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "counts",
                            name + ".py")
        spec = importlib.util.spec_from_file_location("portbench_counts_" + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn = mod.flops
    return fn(**shape)
