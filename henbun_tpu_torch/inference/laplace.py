"""Laplace approximation for GP models with non-Gaussian likelihoods.

Find the posterior mode of the whitened latent by damped saddle-free Newton
iteration and approximate the posterior by the Gaussian with the mode's
curvature (GPML ch. 3.4). With f = Lk v, v ~ N(0, I), the mode maximizes

    psi(v) = sum_i loglik_i((Lk v)_i) - 0.5 v^T v

by steps solving (I + Lk^T |W| Lk) d = grad psi, W = -d2 loglik / df^2:
|W| keeps the system positive definite with the right step scale where a
heavy-tailed likelihood (Student-t) has negative curvature. Each iteration
tries step sizes (1, 0.3, 0.1, 0.03) and keeps the best psi. The evidence
and the covariance use the true W at the mode.

Hyperparameter gradients come from the implicit function theorem at the
mode: the mode v* is found on detached inputs, and
v* + B^-1 (F(theta) - F(theta).detach()) with F(v, theta) =
Lk^T grad loglik(Lk v) - v and B = I + Lk^T W Lk carries the IFT gradient
dv*/dtheta = B^-1 dF/dtheta while its value stays v*.
``implicit_diff=False`` differentiates through the unrolled iterations
instead.

With ``fused=(tag, params)`` a batched call (a BatchedOptimizer fleet under
``torch.func.vmap``) runs the whole Newton forward as one launch of the
hand-written CUDA kernel K3 (``ops/cuda_newton.py``) on CUDA tensors, or
its plain version on CPU tensors; an unbatched call runs the generic loop.
The multiclass engine of the JAX package is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import densities
from .._settings import settings
from ..ops import cuda_newton
from ..ops.linalg import _to_front, eye, matmul_hp, safe_cholesky, tri_solve, tri_solve_T


class LaplaceResult(NamedTuple):
    """Mode and curvature of p(v | y) for f = Lk v, v ~ N(0, I).

    log_marginal is the Laplace evidence approximation
    log q(y) = psi(v*) - 0.5 log|I + Lk^T W Lk|; f_mode/f_var are the
    latent's posterior mode and marginal variances at the training inputs;
    grad_norm is |grad psi(v*)| (a convergence diagnostic, ~0 at a mode).
    """

    v_mode: torch.Tensor
    f_mode: torch.Tensor
    f_var: torch.Tensor
    log_marginal: torch.Tensor
    grad_norm: torch.Tensor


def _psi_parts(loglik_fn, Lk, v):
    f = matmul_hp(Lk, v)
    ll = torch.sum(loglik_fn(f))
    return ll - 0.5 * torch.sum(v * v), f


def _ll_sum(loglik_fn):
    return lambda f: torch.sum(loglik_fn(f))


def _grad_and_curvature(loglik_fn, f):
    """(d loglik / df, -d2 loglik / df^2), both [n, 1], in one
    forward-over-reverse pass: the likelihood factorizes over datapoints,
    so its Hessian is diagonal and the Hessian-times-ones product of the
    gradient is that diagonal."""
    g, hv = torch.func.jvp(
        torch.func.grad(_ll_sum(loglik_fn)), (f,), (torch.ones_like(f),)
    )
    return g, -hv


def _curvature(loglik_fn, f):
    """-d2 loglik / df^2, [n, 1]."""
    return _grad_and_curvature(loglik_fn, f)[1]


def _floor_jitter(B, base=1e-6):
    """Scale-aware jitter for PD matrices of the form I + (PSD): the base
    scaled by the diagonal's magnitude keeps the floor representable next
    to the matrix's scale in float32."""
    d = torch.diagonal(B, dim1=-2, dim2=-1)
    return base * (1.0 + torch.max(d))


def _with_floor(B, base=1e-6):
    """B + detached(scale-aware floor) * I, ready for safe_cholesky; the
    floor adds no hyperparameter gradient."""
    f = _floor_jitter(B, base).detach()
    return B + f * eye(B.shape[-1], B.dtype, B.device)


def _newton_iterations(loglik_fn, Lk, newton_iters, jitter):
    """The damped saddle-free Newton loop; returns v_star [m, 1]."""
    m = Lk.shape[-1]
    I = eye(m, Lk.dtype, Lk.device)
    alphas = torch.tensor((1.0, 0.3, 0.1, 0.03), dtype=Lk.dtype, device=Lk.device)
    v = torch.zeros((m, 1), dtype=Lk.dtype, device=Lk.device)
    for _ in range(int(newton_iters)):
        psi0, f = _psi_parts(loglik_fn, Lk, v)
        g, W_true = _grad_and_curvature(loglik_fn, f)
        W = torch.abs(W_true)  # saddle-free: PD, right scale
        grad_psi = matmul_hp(Lk.mT, g) - v
        B = I + matmul_hp(Lk.mT, W * Lk)
        Lb = safe_cholesky(_with_floor(B, jitter), jitter)
        half = torch.linalg.solve_triangular(Lb, grad_psi, upper=False)
        d = torch.linalg.solve_triangular(Lb.mT, half, upper=True)
        # the full step is taken on a near-tie (tol ~ float32 resolution of
        # psi); smaller steps must strictly improve on the best so far
        tie_tol = 1e-5 * (1.0 + torch.abs(psi0))
        V_try = v[None] + alphas[:, None, None] * d[None]  # [4, m, 1]
        F_try = matmul_hp(Lk, V_try)
        psis = torch.func.vmap(lambda ff: torch.sum(loglik_fn(ff)))(F_try) - 0.5 * torch.sum(
            V_try * V_try, dim=(-2, -1)
        )
        best_v, best_psi = v, psi0
        for i in range(4):
            take = psis[i] >= best_psi - tie_tol if i == 0 else psis[i] > best_psi
            best_v = torch.where(take, V_try[i], best_v)
            best_psi = torch.where(take, psis[i], best_psi)
        v = best_v
    return v


# ------------------------------------------ fused batched Newton forward (K3)
def _fused_loglik(tag, df, y, var):
    """The generic-path likelihood matching the kernel's closed forms."""
    if tag == "bernoulli_logit":
        return lambda f: densities.bernoulli_logit(y, f)
    if tag == "student_t":
        return lambda f: densities.student_t(y, f, var, df)
    raise ValueError("unsupported fused likelihood %r" % (tag,))


def _fused_spec(fused, like):
    """(tag, df, y, var) of a ``fused=(tag, params)`` declaration. A
    ``student_t`` spec must name its ``df`` (the JAX package takes a
    missing df as 0, which is no density)."""
    tag, p = fused
    if tag not in cuda_newton.TAGS:
        raise ValueError("unsupported fused likelihood %r" % (tag,))
    if tag == "student_t":
        if "df" not in p:
            raise ValueError("a fused student_t spec needs its 'df'")
        df = float(p["df"])
        if not (math.isfinite(df) and df > 0):
            raise ValueError("a fused student_t spec needs a finite df > 0; got %r" % (df,))
    else:
        df = 0.0

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)

    var = p.get("var")
    var = torch.ones((1,), dtype=like.dtype, device=like.device) if var is None else tensor(var)
    return tag, df, tensor(p["y"]), var


def _newton_batched(Lk, y, var, tag, df, iters, jitter):
    """The batched mode-find on [B, n, m] tensors: K3 on CUDA tensors with
    ``[cuda] use_kernels`` on, its plain version on CPU tensors, else (a
    wider or float64 batch, or CUDA with use_kernels off) the generic loop
    under vmap, as the JAX package sends such calls to XLA."""
    Bt, n, m = Lk.shape
    dev = Lk.device.type
    kernel_shape = (
        Lk.dtype == torch.float32
        and y.dtype == torch.float32
        and var.dtype == torch.float32
        and 0 < n <= cuda_newton.MAX_N
        and 0 < m <= cuda_newton.MAX_N
    )
    if kernel_shape and (dev == "cpu" or (dev == "cuda" and bool(settings.cuda.use_kernels))):
        return cuda_newton.newton_mode_vbatched(
            Lk.contiguous(), y.contiguous(), var.reshape(Bt, 1).contiguous(),
            tag, df=df, iters=iters, jitter=jitter,
        )
    return torch.func.vmap(
        lambda a, b, c: _newton_iterations(_fused_loglik(tag, df, b, c), a, iters, jitter)
    )(Lk, y, var)


class FusedNewtonMode(torch.autograd.Function):
    """The Newton mode of a declared closed-form likelihood, forward only:
    an unbatched call (Lk [n, m]) is the generic loop; under
    ``torch.func.vmap`` the rule moves the batch to the front and the call
    sees the whole batch at once (:func:`_newton_batched`), the
    counterpart of the JAX package's ``custom_vmap`` rule. The inputs are
    detached; :func:`laplace_whitened` attaches the IFT gradient."""

    @staticmethod
    def forward(Lk, y, var, tag, df, iters, jitter):
        if Lk.ndim == 2:
            return _newton_iterations(_fused_loglik(tag, df, y, var), Lk, iters, jitter)
        lead, (n, m) = Lk.shape[:-2], Lk.shape[-2:]
        Bt = int(np.prod(lead))
        v = _newton_batched(
            Lk.reshape(Bt, n, m), y.reshape((Bt,) + y.shape[len(lead):]),
            var.reshape((Bt,) + var.shape[len(lead):]), tag, df, iters, jitter,
        )
        return v.reshape(lead + (m, 1))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, Lk, y, var, tag, df, iters, jitter):
        size = info.batch_size
        return FusedNewtonMode.apply(
            _to_front(Lk, in_dims[0], size), _to_front(y, in_dims[1], size),
            _to_front(var, in_dims[2], size), tag, df, iters, jitter,
        ), 0


def _attach_ift(loglik_fn, Lk, v_star, jitter):
    """v* with the implicit-function-theorem gradient attached: B is built
    at the mode with the true curvature from detached tensors and factored
    (``safe_cholesky``), then v* + B^-1 (F - F.detach()) by two solves on
    the factor, F = Lk^T grad loglik(Lk v*) - v* with gradients on."""
    v = v_star.detach()
    with torch.no_grad():
        Lk_d = Lk.detach()
        W = _curvature(loglik_fn, matmul_hp(Lk_d, v))
        B = eye(Lk.shape[-1], Lk.dtype, Lk.device) + matmul_hp(Lk_d.mT, W * Lk_d)
        Lb = safe_cholesky(_with_floor(B, jitter), jitter)
    F = matmul_hp(Lk.mT, torch.func.grad(_ll_sum(loglik_fn))(matmul_hp(Lk, v))) - v
    return v + tri_solve_T(Lb, tri_solve(Lb, F - F.detach()))


def laplace_whitened(loglik_fn, Lk, newton_iters=15, jitter=1e-6,
                     implicit_diff=True, fused=None):
    """Laplace approximation of the latent posterior for f = Lk v.

    loglik_fn: f [n, 1] -> elementwise log-likelihood [n, 1] (twice
    differentiable; summed internally). Lk: [n, n] lower factor of the
    (scaled) prior covariance, cov(f) = Lk Lk^T, or a rectangular [n, m]
    projection of a whitened m-dim latent (the inducing-point form; every
    factorization is then m x m).

    Returns a :class:`LaplaceResult`, differentiable with respect to
    everything `loglik_fn` and `Lk` close over: by the implicit function
    theorem at the mode (`implicit_diff=True`, skipped when gradients are
    off), or through the unrolled Newton loop (`implicit_diff=False`).

    fused: optional ``(tag, params)`` declaring the likelihood's closed
    form, ``("bernoulli_logit", {"y": Y})`` or
    ``("student_t", {"y": Y, "var": var, "df": 3.0})`` (``df`` required),
    so a batched call runs the Newton forward through K3. `loglik_fn`
    stays the source of truth for the evidence and the gradient; the
    declared form must match it.
    """
    if implicit_diff:
        if fused is not None:
            tag, df, y, var = _fused_spec(fused, Lk)
            v_star = FusedNewtonMode.apply(
                Lk.detach(), y.detach(), var.detach(), tag, df,
                int(newton_iters), float(jitter),
            )
        else:
            with torch.no_grad():
                v_star = _newton_iterations(loglik_fn, Lk.detach(), newton_iters, jitter)
        if torch.is_grad_enabled():
            v_star = _attach_ift(loglik_fn, Lk, v_star, float(jitter))
    else:
        v_star = _newton_iterations(loglik_fn, Lk, newton_iters, jitter)

    m = Lk.shape[-1]
    psi, f_star = _psi_parts(loglik_fn, Lk, v_star)
    # gradient and true curvature at the mode for the evidence/covariance
    g, W = _grad_and_curvature(loglik_fn, f_star)
    grad_psi = matmul_hp(Lk.mT, g) - v_star
    B = eye(m, Lk.dtype, Lk.device) + matmul_hp(Lk.mT, W * Lk)
    Lb = safe_cholesky(_with_floor(B, jitter), jitter)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Lb, dim1=-2, dim2=-1)))
    log_marginal = psi - 0.5 * logdet
    # marginals of f = Lk v under N(v*, B^-1): colnorm(Lb^-1 Lk^T)^2
    V = torch.linalg.solve_triangular(Lb, Lk.mT, upper=False)
    f_var = torch.sum(torch.square(V), dim=-2)[..., None]
    return LaplaceResult(
        v_mode=v_star,
        f_mode=f_star,
        f_var=f_var,
        log_marginal=log_marginal,
        grad_norm=torch.linalg.norm(grad_psi),
    )


def laplace_projected_marginals(loglik_fn, A, res, Astar, corr_diag, jitter=1e-6):
    """Predictive latent marginals (mean [n*, 1], var [n*, 1]) under a
    rectangular (inducing-point) Laplace posterior: with
    q(v) = N(v_mode, B^-1), B = I_m + A^T W A at the true mode curvature,

        E[f*] = Astar v_mode,  V[f*] = colnorm(Lb^-1 Astar^T)^2 + corr_diag.
    """
    m = A.shape[-1]
    mean = matmul_hp(Astar, res.v_mode)
    W = _curvature(loglik_fn, res.f_mode)
    B = eye(m, A.dtype, A.device) + matmul_hp(A.mT, W * A)
    Lb = safe_cholesky(_with_floor(B, jitter), jitter)
    G = tri_solve(Lb, Astar.mT)  # [m, n*]
    var = (torch.sum(torch.square(G), dim=-2) + corr_diag)[..., None]
    return mean, var


def laplace_latent_marginals(loglik_fn, Lk, res, Ks, kdiag, jitter=1e-6):
    """Predictive latent marginals (mean [n*, 1], var [n*, 1]) at new inputs
    under a Laplace posterior. res: a :class:`LaplaceResult` for
    (loglik_fn, Lk); Ks: prior cross covariance cov(f, f*) [n, n*]; kdiag:
    prior variances at the new inputs [n*]. With A = Lk^-1 Ks and
    B = I + Lk^T W Lk (W the true mode curvature):

        E[f*] = A^T v_mode
        V[f*] = kdiag - colnorm(A)^2 + colnorm(Lb^-1 A)^2

    Variances are clamped at 0 (float32 cancellation at near-duplicate
    inputs). Check ``res.grad_norm``: away from a genuine mode B can be
    indefinite for a non-log-concave likelihood, and the result NaN.
    """
    n = Lk.shape[-1]
    A = tri_solve(Lk, Ks)  # [n, n*]
    mean = matmul_hp(A.mT, res.v_mode)
    W = _curvature(loglik_fn, res.f_mode)
    B = eye(n, Lk.dtype, Lk.device) + matmul_hp(Lk.mT, W * Lk)
    Lb = safe_cholesky(B, jitter)
    G = tri_solve(Lb, A)
    var = torch.clamp(
        kdiag - torch.sum(torch.square(A), dim=-2) + torch.sum(torch.square(G), dim=-2),
        min=0.0,
    )[..., None]
    return mean, var
