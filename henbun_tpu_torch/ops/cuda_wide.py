"""Triangular solves of one [128, 128] float32 factor against a wide
[128, m] right-hand side: the hand-written CUDA kernel
``csrc/widesolve128.cu`` (K6), its plain PyTorch version and launch
counters.

Replaces the TPU kernel ``henbun_tpu/ops/pallas_wide.py``
(``wide_lsolve128`` and ``wide_usolve128``, one ``pallas_call``):
:func:`wide_lsolve128` solves L X = B reading only L's lower triangle,
:func:`wide_usolve128` solves U X = B reading only U's upper triangle; m is
a positive multiple of 128, at most 8192. On the card the kernel runs one
block of 256 threads for each tile of :func:`tile_cols` columns of B, with
the triangle and the tile in shared memory, a blocked substitution over
32-row diagonal blocks (see the source). As in the JAX package,
nothing dispatches to it: the blocked algorithms (``ops/blocked.py``) chunk
their panels onto K2 instead, and K6 is reached by direct import.

Each entry takes the kernel for CUDA tensors and the plain version for CPU
tensors, and raises on anything else; nothing falls back. Its
``.launches`` counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 128
MAX_M = 8192
COLS = (64, 32, 16)  # the kernel's tile widths, widest first
GRID_TARGET = 120    # blocks that fill most of an H100's 132 SMs
# widesolve128_launch(T, B, X, m, upper, cols, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def tile_cols(m):
    """Columns of B a block takes: the widest of 64 and 32 that still gives
    GRID_TARGET blocks, else 16. A block's time is mostly the diagonal
    chain, whatever its width, so narrow tiles put more SMs on the same
    work (m = 128: 8 blocks; 3968: 124; 8192: 128)."""
    for cols in COLS[:-1]:
        if m // cols >= GRID_TARGET:
            return cols
    return COLS[-1]


def wide_solve128_plain(T, B, upper):
    """The kernel's function as a row loop on tensors: forward substitution
    on T's lower triangle, or (``upper``) back substitution on its upper
    one; the other triangle is never read."""
    X = torch.empty_like(B)
    rows = reversed(range(TILE)) if upper else range(TILE)
    for i in rows:
        if upper:
            coef, done = T[i, i + 1 :], X[i + 1 :]
        else:
            coef, done = T[i, :i], X[:i]
        X[i] = (B[i] - coef @ done) / T[i, i]
    return X


def _check(T, B):
    """The reference's checks (pallas_wide._check); both operands are then
    taken in float32, as the reference casts them."""
    for name, t in (("factor", T), ("rhs", B)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("the wide solves take tensors (%s)" % name)
    if tuple(T.shape) != (TILE, TILE):
        raise ValueError("factor must be [128, 128]; got %s" % (tuple(T.shape),))
    if B.ndim != 2 or B.shape[0] != TILE:
        raise ValueError("rhs must be [128, m]; got %s" % (tuple(B.shape),))
    m = B.shape[-1]
    if m % TILE or not 0 < m <= MAX_M:
        raise ValueError("m must be a positive multiple of 128 and <= 8192; got %d" % m)
    if T.device != B.device:
        raise ValueError("factor on %s, rhs on %s" % (T.device, B.device))
    return T.to(torch.float32).contiguous(), B.to(torch.float32).contiguous()


def _solve(T, B, upper, entry):
    T, B = _check(T, B)
    if T.device.type == "cpu":
        return wide_solve128_plain(T, B, upper)
    if T.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU, not %s" % (entry.__name__, T.device))
    # the kernel copies 16 bytes at a time
    T, B = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (T, B))
    X = torch.empty_like(B)
    m = B.shape[-1]
    fn = _build.load("widesolve128", "widesolve128_launch", _ARGTYPES)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = fn(T.data_ptr(), B.data_ptr(), X.data_ptr(), m, int(upper), tile_cols(m), stream)
    if err != 0:
        raise RuntimeError("widesolve128 kernel launch failed: cudaError %d" % err)
    entry.launches += 1
    return X


def wide_lsolve128(L, B):
    """X [128, m] with L X = B; L [128, 128] lower triangular (only the
    lower triangle is read)."""
    return _solve(L, B, False, wide_lsolve128)


def wide_usolve128(U, B):
    """X [128, m] with U X = B; U [128, 128] upper triangular (only the
    upper triangle is read)."""
    return _solve(U, B, True, wide_usolve128)


wide_lsolve128.launches = 0
wide_usolve128.launches = 0
