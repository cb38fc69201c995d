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

Every contraction over the rows (sum loglik, Lk^T g, Lk^T W Lk, the
ladder's trial psis, the IFT's B and F) goes through
``parallel.rows.row_sum``: in a row-sharded ``ShardedOptimizer`` step each
rank holds a block of the rows and the sums are all-reduced, so the m x m
algebra and the ladder's choice are the same on every rank; elsewhere
``row_sum`` is the identity.

With ``fused=(tag, params)`` a batched call (a BatchedOptimizer fleet under
``torch.func.vmap``) runs the whole Newton forward as one launch of the
hand-written CUDA kernel K3 (``ops/cuda_newton.py``) on CUDA tensors, or
its plain version on CPU tensors; an unbatched call runs the generic loop.

The K-class softmax likelihood couples the classes at each point, so it
has its own engine (``multiclass_laplace_projected``, GPML ch. 3.5's block
curvature). It never forms the Newton matrix H = I + blocks(A^T W A):
every solve and the evidence's log-determinant go through the square-root
factor of the curvature (``_softmax_G``) and its shifted CholeskyQR2
factor (``_sqrt_gram_factor``), which keeps H's unit eigenvalue floor in
float32 at n * k_var scales where a float32-built H has lost it. Its
contractions over the rows (the softmax log-likelihood and A^T G, the
trial psis, the factor's two Grams, the IFT's A^T G) go through
``row_sum`` too, and its two ``autograd.Function``s reduce their
backward's cotangent as ``row_sum``'s backward would, so
``SparseGPMulticlass.log_marginal_laplace`` is row-sharded like the
scalar engine's evidence.
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
from ..parallel.rows import current_group, row_sum, sharded_rows


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


def _ll_sum(loglik_fn):
    return lambda f: torch.sum(loglik_fn(f))


def _grad_and_curvature(loglik_fn, f):
    """(d loglik / df, -d2 loglik / df^2), both [n, 1]: the likelihood
    factorizes over datapoints, so its Hessian is diagonal and the
    Hessian-times-ones product of the gradient is that diagonal.

    Outside any functorch transform (a single model's Newton loop, IFT and
    evidence; a prediction) the two come from two reverse passes of
    autograd, each keeping its graph where a gradient is carried: far less
    host time than a functorch pass, which dispatches every operation
    through its transform layers. Under a transform
    (a fleet's vmap, a sampler's batched gradient) they come from one
    forward-over-reverse pass. Under ``torch.export`` (a served program,
    no gradient to carry, and no functorch transform it can replay) the
    reverse passes run on a detached f."""
    if torch.compiler.is_exporting() or torch._C._functorch.maybe_current_level() is None:
        keep = torch.is_grad_enabled() and not torch.compiler.is_exporting()
        with torch.enable_grad():
            x = f if keep and f.requires_grad else f.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(loglik_fn(x)), x, create_graph=True)
            (hv,) = torch.autograd.grad(torch.sum(g), x, create_graph=keep)
        return (g, -hv) if keep else (g.detach(), -hv)
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


def _row_terms(loglik_fn, Lk, f, g, W):
    """(sum loglik(f), Lk^T g, Lk^T W Lk): the loop's and the evidence's
    contractions over the rows, summed over every rank's rows in one
    reduction (``parallel/rows.py``; the identity in one process)."""
    return row_sum(torch.sum(loglik_fn(f)), matmul_hp(Lk.mT, g), matmul_hp(Lk.mT, W * Lk))


def _newton_iterations(loglik_fn, Lk, newton_iters, jitter):
    """The damped saddle-free Newton loop; returns v_star [m, 1]."""
    m = Lk.shape[-1]
    I = eye(m, Lk.dtype, Lk.device)
    alphas = torch.tensor((1.0, 0.3, 0.1, 0.03), dtype=Lk.dtype, device=Lk.device)
    v = torch.zeros((m, 1), dtype=Lk.dtype, device=Lk.device)
    for _ in range(int(newton_iters)):
        f = matmul_hp(Lk, v)
        g, W_true = _grad_and_curvature(loglik_fn, f)
        W = torch.abs(W_true)  # saddle-free: PD, right scale
        ll, Ltg, LtWL = _row_terms(loglik_fn, Lk, f, g, W)
        psi0 = ll - 0.5 * torch.sum(v * v)
        grad_psi = Ltg - v
        B = I + LtWL
        Lb = safe_cholesky(_with_floor(B, jitter), jitter)
        half = torch.linalg.solve_triangular(Lb, grad_psi, upper=False)
        d = torch.linalg.solve_triangular(Lb.mT, half, upper=True)
        # the full step is taken on a near-tie (tol ~ float32 resolution of
        # psi); smaller steps must strictly improve on the best so far
        tie_tol = 1e-5 * (1.0 + torch.abs(psi0))
        V_try = v[None] + alphas[:, None, None] * d[None]  # [4, m, 1]
        F_try = matmul_hp(Lk, V_try)
        # the ladder decides on the psis of all rows: every rank of a
        # row-sharded step takes the same step
        lls = row_sum(torch.func.vmap(lambda ff: torch.sum(loglik_fn(ff)))(F_try))
        psis = lls - 0.5 * torch.sum(V_try * V_try, dim=(-2, -1))
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
        B = eye(Lk.shape[-1], Lk.dtype, Lk.device) + row_sum(matmul_hp(Lk_d.mT, W * Lk_d))
        Lb = safe_cholesky(_with_floor(B, jitter), jitter)
    F = row_sum(matmul_hp(Lk.mT, torch.func.grad(_ll_sum(loglik_fn))(matmul_hp(Lk, v)))) - v
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
    f_star = matmul_hp(Lk, v_star)
    # gradient and true curvature at the mode for the evidence/covariance
    g, W = _grad_and_curvature(loglik_fn, f_star)
    ll, Ltg, LtWL = _row_terms(loglik_fn, Lk, f_star, g, W)
    psi = ll - 0.5 * torch.sum(v_star * v_star)
    grad_psi = Ltg - v_star
    B = eye(m, Lk.dtype, Lk.device) + LtWL
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


# --------------------------------------------------------- multiclass (softmax)
class MulticlassLaplaceResult(NamedTuple):
    """Mode and curvature for the K-class softmax likelihood over a
    projected latent F = A U (U [m, K] whitened per class).

    u_mode: [m, K]; f_mode: the training logits [n, K]; log_marginal: the
    Laplace evidence; grad_norm: |grad psi| at the mode (~0 when
    converged)."""

    u_mode: torch.Tensor
    f_mode: torch.Tensor
    log_marginal: torch.Tensor
    grad_norm: torch.Tensor


def _per_model(fn, *args):
    """fn on one model's 2-D operands, or under torch.func.vmap over a
    leading batch axis (the batch an autograd.Function's vmap rule hands
    over), so the factorizations and solves inside see the whole batch
    through their own vmap rules."""
    if args[0].ndim == 2:
        return fn(*args)
    return torch.func.vmap(fn)(*args)


def _one_hot(y_idx, n_classes, dtype):
    """[n, K] one-hot rows of integer labels (a comparison, so it runs
    under vmap)."""
    classes = torch.arange(int(n_classes), device=y_idx.device)
    return (y_idx.long()[..., None] == classes).to(dtype)


def _softmax_rows(A, Y1, u):
    """(F, Pi, G, ll): the logits [..., n, K] of these rows, their
    softmax, dloglik/dF = Y1 - Pi, and their log-likelihood summed over
    the rows (this rank's only). A leading axis on u (a batch of trial
    points) gives an ll each."""
    F = matmul_hp(A, u)  # [..., n, K]
    Pi = torch.softmax(F, dim=-1)
    ll = torch.sum(Y1 * (F - torch.logsumexp(F, dim=-1, keepdim=True)), dim=(-2, -1))
    return F, Pi, Y1 - Pi, ll


def _softmax_psi(A, Y1, u):
    """(psi, F, G, Pi, grad): the log-posterior value, logits, dloglik/dF,
    softmax and grad psi = A^T G - u [m, K]. The log-likelihood and A^T G
    are sums over the rows, taken in one ``row_sum``; the prior terms are
    replicated, never summed over ranks."""
    F, Pi, G, ll = _softmax_rows(A, Y1, u)
    ll, AtG = row_sum(ll, matmul_hp(A.mT, G))
    return ll - 0.5 * torch.sum(u * u), F, G, Pi, AtG - u


def _softmax_G(A, Pi):
    """The square-root factor G [n K, K m] of the blocked softmax curvature:
    G^T G = blocks(A^T W_cc' A) with W_i = diag(pi_i) - pi_i pi_i^T (GPML
    ch. 3.5's coupling), so the Newton matrix H = I + G^T G is never
    formed. With q = sqrt(pi), W = D^1/2 (I - q q^T) D^1/2 and I - q q^T is
    an orthogonal projector, so C = D^1/2 (I - q q^T), C_ce = q_c d_ce -
    pi_c q_e, satisfies C C^T = W exactly; G stacks the rows
    G[(n, e), (c, i)] = C_n[c, e] A[n, i]. Column order (c, i) -> c m + i,
    the u layout used throughout.

    Factorizations derived from G see condition sqrt(cond H) and keep the
    unit floor exact; a float32-built H loses it to entry rounding at
    n k_var ~ 2e5 a class."""
    n, m = A.shape
    K = Pi.shape[-1]
    q = torch.sqrt(Pi)
    eyeK = torch.eye(K, dtype=A.dtype, device=A.device)
    C = q[:, :, None] * eyeK[None] - Pi[:, :, None] * q[:, None, :]  # [n, c, e]
    return (C.permute(0, 2, 1)[..., None] * A[:, None, None, :]).reshape(n * K, K * m)


def _cholesky_nan(B):
    """Lower Cholesky factor, all NaN where B is not positive definite (as
    ``jnp.linalg.cholesky``; ``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(B)
    return torch.where((info > 0)[..., None, None], float("nan"), L)


def _sqrt_gram_factor(G, jitter=1e-4):
    """Upper-triangular R with R^T R = I + G^T G at Householder-QR accuracy,
    from matmuls and two small p x p Cholesky factorizations: shifted
    CholeskyQR2 (Fukaya et al. 2020).

    Pass 1 factors the floored normal matrix B0 = I + G^T G + f I; pass 2
    re-orthogonalizes: with Q1 = [G; I] R0^-1, B1 = Q1^T Q1 is near the
    identity and R = chol(B1)^T R0 satisfies R^T R = I + G^T G exactly in
    exact arithmetic, so the shift f cancels. diag(R) > 0.

    The shift base is 1e-4 relative (the library's usual base is 1e-6):
    it cancels in pass 2, so a generous shift costs nothing, and at
    n k_var ~ 1e7 a matmul's accumulated float32 rounding of B0 can exceed
    a 1e-6 relative floor and leave pass 1 indefinite."""
    p = G.shape[-1]
    I = eye(p, G.dtype, G.device)
    # the two Grams are sums over G's rows (``row_sum``): in a row-sharded
    # step every rank factors the same p x p matrices, so safe_cholesky's
    # retry flag reads alike on every rank; Gi = G R0^-1 stays per row
    B0 = I + row_sum(matmul_hp(G.mT, G))
    L0 = safe_cholesky(_with_floor(B0, jitter), jitter)
    L0inv = tri_solve(L0, I)
    R0inv = L0inv.mT
    Gi = matmul_hp(G, R0inv)
    B1 = row_sum(matmul_hp(Gi.mT, Gi)) + matmul_hp(L0inv, R0inv)
    L1 = _cholesky_nan(B1)
    return matmul_hp(L1.mT, L0.mT)


def _sqrt_solve(R, b):
    """(I + G^T G)^-1 b from the CholQR2 factor: R^-1 (R^-T b). R^T is
    lower triangular, so both solves take the library's solve dispatch."""
    RT = R.mT
    return tri_solve_T(RT, tri_solve(RT, b))


def _logdet_of(G):
    R = _sqrt_gram_factor(G)
    return 2.0 * torch.sum(torch.log(torch.diagonal(R, dim1=-2, dim2=-1))), R


def _logdet_grad(G, R, lam):
    """2 lam G H^-1, H^-1 = R^-1 R^-T from the saved factor."""
    Rinv = tri_solve_T(R.mT, eye(R.shape[-1], R.dtype, R.device))
    return 2.0 * lam * matmul_hp(G, matmul_hp(Rinv, Rinv.mT))


class LogdetSqrtGram(torch.autograd.Function):
    """log det(I + G^T G) through the square-root factor. The backward is
    the exact identity d logdet = <2 G H^-1, dG> from the saved factor
    (one triangular inverse and one tall matmul). Under vmap the rule
    hands the whole batch to one call. In a row-sharded step G is this
    rank's rows and G^T G a sum over every rank's: the backward weights
    these rows by every rank's lambda (its all-reduce), as ``row_sum``'s
    backward would (``parallel/rows.py``)."""

    @staticmethod
    def forward(G):
        return _per_model(_logdet_of, G)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(inputs[0], output[1])
        ctx.group = current_group()

    @staticmethod
    def backward(ctx, lam, _):
        G, R = ctx.saved_tensors
        with sharded_rows(ctx.group):
            lam = row_sum(lam)
        return _per_model(_logdet_grad, G, R, lam)

    @staticmethod
    def vmap(info, in_dims, G):
        out = LogdetSqrtGram.apply(_to_front(G, in_dims[0], info.batch_size))
        return out, (0, 0)


def logdet_sqrt_gram(G):
    """log det(I + G^T G) via the square-root factor: stable where the
    float32-built normal matrix has lost its unit eigenvalue floor; see
    :class:`LogdetSqrtGram`."""
    return LogdetSqrtGram.apply(G)[0]


def _softmax_newton(A, Y1, iters):
    """Damped Newton iterations for the softmax mode; softmax is
    log-concave, so H is positive definite. The same four-step ladder as
    the scalar engine; the direction solves take the CholQR2 factor (H is
    never formed)."""
    n, m = A.shape
    K = Y1.shape[-1]
    alphas = torch.tensor((1.0, 0.3, 0.1, 0.03), dtype=A.dtype, device=A.device)
    u = torch.zeros((m, K), dtype=A.dtype, device=A.device)
    for _ in range(int(iters)):
        psi0, F, G, Pi, grad = _softmax_psi(A, Y1, u)
        R = _sqrt_gram_factor(_softmax_G(A, Pi))
        d = _sqrt_solve(R, grad.mT.reshape(K * m, 1))
        d = d.reshape(K, m).mT  # [m, K]
        tie_tol = 1e-5 * (1.0 + torch.abs(psi0))
        U_try = u[None] + alphas[:, None, None] * d[None]  # [4, m, K]
        # the ladder decides on the psis of all rows (one row_sum for the
        # four): every rank of a row-sharded step takes the same step
        lls = row_sum(_softmax_rows(A, Y1, U_try)[3])
        psis = lls - 0.5 * torch.sum(U_try * U_try, dim=(-2, -1))
        best_u, best_psi = u, psi0
        for i in range(4):
            take = psis[i] >= best_psi - tie_tol if i == 0 else psis[i] > best_psi
            best_u = torch.where(take, U_try[i], best_u)
            best_psi = torch.where(take, psis[i], best_psi)
        u = best_u
    return u


def _softmax_mode_vjp(A, Y1, u, ubar):
    """IFT at the mode: F(u; A) = A^T (Y1 - softmax(A u)) - u = 0,
    dF/du = -H, so ubar^T du*/dA = w^T dF/dA with H w = ubar, solved
    through the CholQR2 factor. A^T (Y1 - softmax(A u)) is a sum over the
    rows: its VJP at w is these rows' VJP at w summed over every rank
    (``row_sum``'s backward), so w is all-reduced first."""
    m, K = u.shape
    Pi = torch.softmax(matmul_hp(A, u), dim=-1)
    R = _sqrt_gram_factor(_softmax_G(A, Pi))
    w = _sqrt_solve(R, ubar.mT.reshape(K * m, 1)).reshape(K, m).mT  # [m, K]
    w = row_sum(w)

    def Ffn(A_):
        return matmul_hp(A_.mT, Y1 - torch.softmax(matmul_hp(A_, u), dim=-1))

    _, vjp = torch.func.vjp(Ffn, A)
    return vjp(w)[0]


class SoftmaxModeImplicit(torch.autograd.Function):
    """The softmax Newton mode with the implicit-function-theorem backward
    (the JAX package's custom_vjp): the forward runs the Newton iterations
    on detached inputs, the backward solves H w = ubar at the mode and
    takes the VJP of the stationarity condition with respect to A. In a
    row-sharded step the backward runs in the forward's group."""

    @staticmethod
    def forward(A, Y1, iters):
        return _per_model(lambda a, y: _softmax_newton(a, y, iters), A, Y1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1], output)
        ctx.group = current_group()

    @staticmethod
    def backward(ctx, ubar):
        A, Y1, u = ctx.saved_tensors
        with sharded_rows(ctx.group):
            return _per_model(_softmax_mode_vjp, A, Y1, u, ubar), None, None

    @staticmethod
    def vmap(info, in_dims, A, Y1, iters):
        size = info.batch_size
        return SoftmaxModeImplicit.apply(
            _to_front(A, in_dims[0], size), _to_front(Y1, in_dims[1], size), iters
        ), 0


def multiclass_laplace_projected(A, y_idx, n_classes, newton_iters=15,
                                 implicit_diff=True):
    """Laplace approximation for K-class softmax GP classification on the
    projected (inducing-point) latent F = A U, U ~ N(0, I_{m x K}).

    A [n, m]: the shared per-class projection (sqrt(k_var) (Lm^-1 Kmn)^T);
    y_idx [n] integer labels. The softmax couples the classes at each
    point, so the curvature has GPML ch. 3.5's block structure, which the
    factorizing-likelihood engine cannot express. Evidence gradients come
    from the implicit function theorem at the mode (softmax is
    log-concave: H is positive definite, the mode unique), or with
    ``implicit_diff=False`` through the unrolled iterations.

    Every solve and the evidence's log-determinant take the square-root
    curvature factor (``_softmax_G``, ``_sqrt_gram_factor``). A single 2-D
    model factors its Km x Km matrices on ``torch.linalg``; a fleet with
    K m <= 128 (under vmap) sends them to the batched kernels.
    """
    K = int(n_classes)
    Y1 = _one_hot(y_idx, K, A.dtype)  # [n, K]
    if implicit_diff:
        u_star = SoftmaxModeImplicit.apply(A, Y1, int(newton_iters))
    else:
        u_star = _softmax_newton(A, Y1, int(newton_iters))
    psi, F, G, Pi, grad = _softmax_psi(A, Y1, u_star)
    logdet = logdet_sqrt_gram(_softmax_G(A, Pi))
    return MulticlassLaplaceResult(
        u_mode=u_star,
        f_mode=F,
        log_marginal=psi - 0.5 * logdet,
        grad_norm=torch.linalg.norm(grad),
    )


def multiclass_laplace_joint_marginals(A, res, Astar, corr_diag, jitter=1e-4):
    """Per-point joint class-logit Gaussians at new inputs under the
    multiclass Laplace posterior: means [n*, K] and covariances
    [n*, K, K], cov(F*_c, F*_c') = Astar_j [H^-1]_cc' Astar_j^T plus the
    residual corr_diag on the diagonal. Feed to an E[softmax] estimator
    for predictive probabilities."""
    n, m = A.shape
    K = res.u_mode.shape[-1]
    Pi = torch.softmax(res.f_mode, dim=-1)
    # CholQR2 factor: R^T R = H, so R^T is the lower factor the solve takes
    Lh = _sqrt_gram_factor(_softmax_G(A, Pi), jitter).mT
    means = matmul_hp(Astar, res.u_mode)  # [n*, K]
    ns = Astar.shape[-2]
    # blocks[c m + i, c', j] = d_cc' Astar[j, i]: I_K kron Astar^T
    eyeK = torch.eye(K, dtype=A.dtype, device=A.device)
    blocks = (eyeK[:, None, :, None] * Astar.mT[None, :, None, :]).reshape(K * m, K * ns)
    Gh = tri_solve(Lh, blocks).reshape(K * m, K, ns)
    covs = torch.einsum("rcj,rdj->jcd", Gh, Gh)
    covs = covs + corr_diag[:, None, None] * eyeK[None]
    return means, covs
