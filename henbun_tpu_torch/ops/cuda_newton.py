"""Batched damped saddle-free Newton mode of the Laplace approximation: the
hand-written CUDA kernel ``csrc/newton128.cu`` (K3), its plain PyTorch
version and its launch counter.

Replaces the TPU kernel ``henbun_tpu/ops/pallas_newton.py``
``newton_mode_vbatched`` (body ``_newton_kernel``). For each model b of a
batch it runs ``iters`` iterations of the loop of
``inference/laplace.py::_newton_iterations`` on

    psi(v) = sum_i ll(y_i, (Lk v)_i) - |v|^2 / 2,   Lk [n, m], v [m, 1],

with the likelihood in closed form (``bernoulli_logit``, or ``student_t``
with ``var`` the scale and ``df`` fixed): f = Lk v, the gradient g and
|W| = |-d2 ll / df2|, the system B = I + Lk^T |W| Lk with the scale-aware
floor and the jitter, its Cholesky factor, the direction d = B^-1 (Lk^T g
- v), and the ladder of step sizes (1, 0.3, 0.1, 0.03) that keeps the best
psi, the full step taken on a near-tie. A model whose psi or factor is NaN
keeps its v; nothing of one model reaches another.

On the card the kernel runs one thread block per model with Lk and the
m x m system in shared memory, so the whole loop is one launch and no host
sync (see the source). ``inference/laplace.py`` reaches it for every
batched ``laplace_whitened(fused=...)`` forward on CUDA tensors with
n, m <= 128 while ``[cuda] use_kernels`` is on.

:func:`newton_mode_vbatched` takes the kernel for CUDA tensors and the
plain version for CPU tensors, and raises on anything else; nothing falls
back. ``newton_mode_vbatched.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .cuda_chol import cholesky128_plain
from .cuda_solve import tri_solve128_plain

MAX_N = 128
TAGS = {"bernoulli_logit": 0, "student_t": 1}
ALPHAS = (1.0, 0.3, 0.1, 0.03)
# newton128_launch(Lk, y, var, v, batch, n, m, iters, tag, df, c, jitter, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def student_t_const(df):
    """lgamma((df+1)/2) - lgamma(df/2) - (log df + log pi)/2, in double on
    the host (the Student-t density's constant without its scale term)."""
    return (
        math.lgamma((df + 1.0) * 0.5)
        - math.lgamma(df * 0.5)
        - 0.5 * (math.log(df) + math.log(math.pi))
    )


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def lik_terms(tag, df, y, f, var):
    """(ll, g, |W|) elementwise, in closed form: ll the log-likelihood,
    g = d ll / df and |W| = |d2 ll / df2|. ``var`` is the Student-t scale
    (ignored for ``bernoulli_logit``), broadcast against f."""
    if tag == "bernoulli_logit":
        # log sigmoid(x) = -softplus(-x)
        ll = -y * _softplus(-f) - (1.0 - y) * _softplus(f)
        sig = 1.0 / (1.0 + torch.exp(-f))
        return ll, y - sig, sig * (1.0 - sig)
    if tag == "student_t":
        r = y - f
        s2 = var * var
        denom = df * s2 + r * r
        const = student_t_const(df) - 0.5 * torch.log(s2)
        ll = const - 0.5 * (df + 1.0) * torch.log(denom / (df * s2))
        g = (df + 1.0) * r / denom
        w_true = (df + 1.0) * (df * s2 - r * r) / (denom * denom)
        return ll, g, torch.abs(w_true)
    raise ValueError("unsupported fused likelihood %r" % (tag,))


def newton_mode_plain(Lk, y, var, tag, df=0.0, iters=15, jitter=1e-6):
    """The kernel's arithmetic on batched tensors: Lk [B, n, m], y [B, n, 1],
    var [B, 1] -> v* [B, m, 1]. The factor and the two substitutions are
    the column loops of K1's and K2's plain versions (an all-NaN factor for
    a matrix that is not positive definite)."""
    Bt, n, m = Lk.shape
    dt, dev = Lk.dtype, Lk.device
    eye = torch.eye(m, dtype=dt, device=dev)
    alphas = torch.tensor(ALPHAS, dtype=dt, device=dev)[:, None, None]
    var = var.reshape(Bt, 1, 1)
    v = torch.zeros(Bt, m, 1, dtype=dt, device=dev)
    for _ in range(iters):
        f = Lk @ v
        ll, g, w = lik_terms(tag, df, y, f, var)
        psi0 = ll.sum((1, 2)) - 0.5 * (v * v).sum((1, 2))
        grad_psi = Lk.mT @ g - v
        Bm = eye + Lk.mT @ (w * Lk)
        floor = jitter * (1.0 + torch.diagonal(Bm, dim1=-2, dim2=-1).amax(-1))
        Bm = Bm + floor[:, None, None] * eye
        Bm = Bm + jitter * eye
        Lb = cholesky128_plain(Bm)
        d = tri_solve128_plain(Lb, tri_solve128_plain(Lb, grad_psi), True)
        V = v[:, None] + alphas * d[:, None]  # [B, 4, m, 1]
        ll_t = lik_terms(tag, df, y[:, None], Lk[:, None] @ V, var[:, None])[0]
        psis = ll_t.sum((2, 3)) - 0.5 * (V * V).sum((2, 3))  # [B, 4]
        tie_tol = 1e-5 * (1.0 + torch.abs(psi0))
        best_v, best_psi = v, psi0
        for i in range(len(ALPHAS)):
            p = psis[:, i]
            take = p >= best_psi - tie_tol if i == 0 else p > best_psi
            best_v = torch.where(take[:, None, None], V[:, i], best_v)
            best_psi = torch.where(take, p, best_psi)
        v = best_v
    return v


def _check(Lk, y, var, tag, df):
    for name, t in (("Lk", Lk), ("y", y), ("var", var)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("newton_mode_vbatched takes tensors (%s)" % name)
        if t.dtype != torch.float32:
            raise TypeError("newton_mode_vbatched takes float32, %s is %s" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("newton_mode_vbatched needs contiguous tensors (%s)" % name)
        if t.device != Lk.device:
            raise ValueError("Lk on %s, %s on %s" % (Lk.device, name, t.device))
    if Lk.ndim != 3 or not (0 < Lk.shape[1] <= MAX_N and 0 < Lk.shape[2] <= MAX_N):
        raise ValueError(
            "newton_mode_vbatched needs Lk [B, n, m] with 0 < n, m <= %d; got %s"
            % (MAX_N, tuple(Lk.shape))
        )
    Bt, n = Lk.shape[0], Lk.shape[1]
    if tuple(y.shape) != (Bt, n, 1):
        raise ValueError("y must be [B=%d, n=%d, 1]; got %s" % (Bt, n, tuple(y.shape)))
    if var.numel() != Bt:
        raise ValueError("var must hold one value a model (%d); got %s" % (Bt, tuple(var.shape)))
    if tag not in TAGS:
        raise ValueError("unsupported fused likelihood %r" % (tag,))
    if tag == "student_t" and not (math.isfinite(df) and df > 0):
        raise ValueError("student_t needs a finite df > 0; got %r" % (df,))


def newton_mode_vbatched(Lk, y, var, tag, df=0.0, iters=15, jitter=1e-6):
    """v* [B, m, 1], the Newton mode of each model: Lk [B, n, m], y [B, n, 1],
    var [B, 1] (the Student-t scale; ignored for ``bernoulli_logit``),
    float32, n, m <= 128. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(Lk, y, var, tag, df)
    iters = int(iters)
    if Lk.device.type == "cpu":
        return newton_mode_plain(Lk, y, var, tag, df, iters, jitter)
    if Lk.device.type != "cuda":
        raise ValueError("newton_mode_vbatched runs on CUDA or CPU, not %s" % Lk.device)
    Bt, n, m = Lk.shape
    v = torch.empty(Bt, m, 1, dtype=Lk.dtype, device=Lk.device)
    if Bt == 0:
        return v
    const = student_t_const(df) if tag == "student_t" else 0.0
    fn = _build.load("newton128", "newton128_launch", _ARGTYPES)
    with torch.cuda.device(Lk.device):
        stream = torch.cuda.current_stream(Lk.device).cuda_stream
        err = fn(Lk.data_ptr(), y.data_ptr(), var.data_ptr(), v.data_ptr(), Bt, n, m,
                 iters, TAGS[tag], float(df), const, float(jitter), stream)
    if err != 0:
        raise RuntimeError("newton128 kernel launch failed: cudaError %d" % err)
    newton_mode_vbatched.launches += 1
    return v


newton_mode_vbatched.launches = 0
