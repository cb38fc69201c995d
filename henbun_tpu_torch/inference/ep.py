"""Expectation propagation for GP models with factorizing likelihoods.

The third deterministic inference engine next to the quadrature ELBOs
(``ops/quadrature.py``) and the Laplace approximation
(``inference/laplace.py``): each non-Gaussian likelihood factor is
approximated by a Gaussian site t_i(f_i) = exp(nu_i f_i - tau_i f_i^2 / 2)
whose moments match the tilted distribution cavity x likelihood (GPML ch.
3.6). EP's predictive marginals are the accuracy reference for binary GP
classification.

Parallel EP: every site updates at once from the current posterior
marginals each sweep (one [n] quadrature batch and a rank-n refresh). A
sweep is one Cholesky of B = I + sqrtW K sqrtW and triangular solves, so
a ``BatchedOptimizer`` fleet sends them to the hand kernels K1 and K2
(``ops/linalg.py``) once or more a sweep. Parallel EP needs damping to
converge (default 0.5); the returned ``delta`` is the last sweep's largest
site-parameter change.

Tilted moments are Gauss-Hermite in log-space: logZ_hat =
logsumexp(log w + loglik(f)), moments from the softmax weights. Negative
incoming site precisions (possible for the non-log-concave Student-t) are
clipped at 0: the site degrades to flat rather than destabilizing B.

The evidence uses the natural-parameter form, singularity-free at tau = 0:

    log Z_EP = sum_i [ log Zhat_i + 0.5 log((tau_c + tau)/tau_c)
                       - (nu_c + nu)^2 / (2 (tau_c + tau))
                       + nu_c^2 / (2 tau_c) ]
               - 0.5 log|B| + 0.5 nu^T Sigma nu

The sweeps are a Python loop. With ``implicit_diff=True`` (the default)
they run under ``torch.no_grad()`` and the converged sites are detached,
the counterpart of the JAX package's ``stop_gradient``: at the EP fixed
point log Z_EP is stationary in the sites, so the gradient is the partial
derivative with the sites held fixed, and no graph is kept across sweeps.
``implicit_diff=False`` differentiates through the unrolled sweeps.

Two engines share the sweep: :func:`ep_gp` on an exact [n, n] prior and
:func:`ep_gp_projected` on the rank-m inducing-point prior f = A v (every
factorization m x m). The projected engine's contractions over the rows
(A^T T A, A^T nu, the site terms, the site-change diagnostics) go through
``parallel.rows.row_sum``/``row_max``: in a row-sharded
``ShardedOptimizer`` step each rank sweeps its own block of sites and the
m x m algebra is the same on every rank; elsewhere they are the identity.

The training guard reports the mean |site change|
(the evidence is a sum over sites; the max in ``EPResult.delta`` picks
single float32 tail oscillators at large n).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .._settings import settings
from ..core import context as _ctx
from ..ops.linalg import eye, matmul_hp, safe_cholesky, tri_solve, tri_solve_T
from ..ops.quadrature import _nodes
from ..parallel.rows import row_max, row_sum
from .laplace import _with_floor


class EPResult(NamedTuple):
    """Converged (or `sweeps`-swept) EP posterior.

    f_mean/f_var: posterior latent marginals at the training inputs [n, 1];
    log_marginal: the EP evidence approximation; nu/tau: site natural
    parameters [n] (feed to :func:`ep_latent_marginals` for prediction);
    delta: max |site change| in the final sweep, a convergence diagnostic
    that should be ~0."""

    f_mean: torch.Tensor
    f_var: torch.Tensor
    log_marginal: torch.Tensor
    nu: torch.Tensor
    tau: torch.Tensor
    delta: torch.Tensor


_GUARD_HINT = (
    " EP's fixed-point (implicit_diff) gradient assumes the"
    " sweeps CONVERGED; this run's last-sweep site change"
    " exceeded delta_tol, so evidence gradients are biased."
)


@functools.lru_cache(maxsize=None)
def _node_tensors(deg, dtype, device):
    """Gauss-Hermite nodes and log-weights on the device, made once per
    (deg, dtype, device) rather than copied from the host every sweep."""
    x, w = _nodes(deg)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.log(torch.as_tensor(w, dtype=dtype, device=device)))


def _posterior_from_sites(K, nu, tau, jitter):
    """Stable posterior given sites: B = I + sqrtW K sqrtW (GPML 3.26/3.43
    in natural parameters). Returns (mu [n], diagSigma [n], Lb)."""
    n = K.shape[-1]
    I = eye(n, K.dtype, K.device)
    # the epsilon keeps sqrt's infinite derivative at clipped tau = 0 sites
    # out of the evidence gradients
    sw = torch.sqrt(tau + 1e-12)
    B = I + sw[:, None] * K * sw[None, :]
    Lb = safe_cholesky(B, jitter)
    # Sigma = K - K sw B^-1 sw K;  V = Lb^-1 (sw K)
    V = tri_solve(Lb, sw[:, None] * K)
    diagSigma = torch.diagonal(K, dim1=-2, dim2=-1) - torch.sum(torch.square(V), dim=0)
    mu = matmul_hp(K, nu[:, None])[:, 0] - matmul_hp(V.mT, matmul_hp(V, nu[:, None]))[:, 0]
    return mu, diagSigma, Lb


def _tilted_moments(loglik_fn, m_c, v_c, deg):
    """Gauss-Hermite moments of the tilted distribution
    cavity N(m_c, v_c) x exp(loglik) per site, in log-space.

    Returns (logZ_hat, m_hat, v_hat), each [n]."""
    x, logw = _node_tensors(int(deg), m_c.dtype, m_c.device)
    f = m_c[:, None] + torch.sqrt(2.0 * v_c)[:, None] * x  # [n, deg]
    ll = loglik_fn(f)  # [n, deg] elementwise log-likelihood
    a = logw + ll
    logZ = torch.logsumexp(a, dim=-1)
    p = torch.softmax(a, dim=-1)
    m_hat = torch.sum(p * f, dim=-1)
    # centered second moment: the E[f^2] - m^2 form cancels catastrophically
    # in float32 when a floored cavity puts m_c ~ 1e5
    v_hat = torch.sum(p * torch.square(f - m_hat[:, None]), dim=-1)
    return logZ, m_hat, v_hat


class _Floors:
    """The constants of one EP run as device scalars, made once, so that
    ``torch.maximum`` (which splits the gradient at a tie, as JAX's
    ``maximum`` does; ``clamp`` passes all of it) needs no copy a sweep."""

    def __init__(self, like, tau_cav_floor):
        self.zero = torch.zeros((), dtype=like.dtype, device=like.device)
        self.tiny = torch.full((), 1e-10, dtype=like.dtype, device=like.device)
        self.tau_cav = torch.full((), tau_cav_floor, dtype=like.dtype, device=like.device)
        self.tau_cav_floor = tau_cav_floor


def _cavity(mu, sig2, nu, tau, c):
    """Natural-parameter cavity with a consistent precision floor: where
    1/sig2 - tau falls below the floor (a non-log-concave likelihood whose
    site precision transiently reaches the marginal's), nu_c is zeroed too:
    a flat cavity, not one with precision 1e-6 and an unadjusted O(0.1)
    shift whose mean m_c = nu_c/tau_c ~ 1e5 wrecks the float32 tilted
    moments."""
    raw = 1.0 / sig2 - tau
    clamped = raw < c.tau_cav_floor
    tau_c = torch.where(clamped, c.tau_cav, raw)
    nu_c = torch.where(clamped, c.zero, mu / sig2 - nu)
    return tau_c, nu_c


def _site_change(dtau, dnu):
    """The last sweep's (max, mean) |site change| over every rank's rows
    (``parallel/rows.py``), a diagnostic without gradient. The guard's
    metric is the mean: the evidence is a sum over sites, so the
    stationarity-gradient bias scales with the aggregate residual
    (EPResult.delta keeps the max)."""
    with torch.no_grad():
        at, an = torch.abs(dtau), torch.abs(dnu)
        d = row_max(torch.maximum(torch.max(at), torch.max(an)))
        count = torch.full((), at.shape[-1], dtype=at.dtype, device=at.device)
        s_tau, s_nu, count = row_sum(torch.sum(at), torch.sum(an), count)
        return d, torch.maximum(s_tau / count, s_nu / count)


def _sweeps(posterior, loglik_fn, like, sweeps, damping, deg, c):
    """`sweeps` damped parallel sweeps from flat sites, one per row of
    `like` (K or A). Returns the sites and the last sweep's (max, mean)
    |site change|."""
    n = like.shape[-2]
    nu = torch.zeros((n,), dtype=like.dtype, device=like.device)
    tau = torch.zeros((n,), dtype=like.dtype, device=like.device)
    d = d_mean = torch.zeros((), dtype=like.dtype, device=like.device)
    for i in range(int(sweeps)):
        mu, sig2 = posterior(nu, tau)[:2]
        sig2 = torch.maximum(sig2, c.tiny)
        tau_c, nu_c = _cavity(mu, sig2, nu, tau, c)
        _, m_hat, v_hat = _tilted_moments(loglik_fn, nu_c / tau_c, 1.0 / tau_c, deg)
        v_hat = torch.maximum(v_hat, c.tiny)
        tau_new = torch.maximum(1.0 / v_hat - tau_c, c.zero)
        nu_new = m_hat / v_hat - nu_c
        nu_new = torch.where(tau_new > 0.0, nu_new, c.zero)
        if i == int(sweeps) - 1:
            d, d_mean = _site_change(tau_new - tau, nu_new - nu)
        nu = (1.0 - damping) * nu + damping * nu_new
        tau = (1.0 - damping) * tau + damping * tau_new
    return nu, tau, d, d_mean


def _run_sweeps(posterior, loglik_fn, like, sweeps, damping, deg, c,
                implicit_diff, delta_tol, hint):
    """The sweeps, detached under ``implicit_diff`` with the mean site
    change reported to the training loop's guard. Returns the sites and
    the last sweep's largest change."""
    if not implicit_diff:
        return _sweeps(posterior, loglik_fn, like, sweeps, damping, deg, c)[:3]
    with torch.no_grad():
        nu, tau, d, d_mean = _sweeps(posterior, loglik_fn, like, sweeps, damping, deg, c)
    # the stationarity gradient is only exact at the fixed point: a
    # training run whose sweeps don't converge gets biased gradients, so
    # the residual goes to the Optimizer, which records it in StepMetrics
    # and aborts past delta_tol with the remedy named
    ctx = _ctx.current()
    if ctx is not None:
        ctx.report_diagnostic("ep_delta", d_mean, guard_tol=delta_tol, hint=hint)
    return nu.detach(), tau.detach(), d


def _site_terms(loglik_fn, mu, sig2, nu, tau, deg, c):
    """The site-normalizer sum of the evidence (see the module docstring)
    and the floored marginal variances."""
    sig2 = torch.maximum(sig2, c.tiny)
    tau_c, nu_c = _cavity(mu, sig2, nu, tau, c)
    logZ_hat, _, _ = _tilted_moments(loglik_fn, nu_c / tau_c, 1.0 / tau_c, deg)
    terms = (
        logZ_hat
        + 0.5 * torch.log((tau_c + tau) / tau_c)
        - torch.square(nu_c + nu) / (2.0 * (tau_c + tau))
        + torch.square(nu_c) / (2.0 * tau_c)
    )
    return row_sum(torch.sum(terms)), sig2


def ep_gp(loglik_fn, K, sweeps=30, damping=0.5, jitter=None, deg=20,
          tau_cav_floor=1e-6, implicit_diff=True, delta_tol=1e-2):
    """Parallel EP for f ~ N(0, K) with a factorizing likelihood.

    loglik_fn: f [n, deg] -> elementwise log-likelihood [n, deg] (close
    over the observations with a trailing broadcast axis). K: [n, n] prior
    covariance (scaled by the kernel variance before the call). Returns
    :class:`EPResult`, differentiable with respect to everything
    `loglik_fn` and `K` close over: by the stationarity property
    (``implicit_diff=True``; inside a training evaluation the last sweep's
    mean site change is reported as the guarded diagnostic ``ep_delta``)
    or through the unrolled sweeps (``implicit_diff=False``).
    """
    if jitter is None:
        jitter = settings.numerics.jitter_level
    c = _Floors(K, tau_cav_floor)
    nu, tau, d = _run_sweeps(
        lambda nu_, tau_: _posterior_from_sites(K, nu_, tau_, jitter),
        loglik_fn, K, sweeps, damping, deg, c, implicit_diff, delta_tol,
        _GUARD_HINT
        + " Raise sweeps, lower damping (non-log-concave"
        " likelihoods often need <=0.3), raise delta_tol if the"
        " residual is acceptable, or pass implicit_diff=False"
        " to differentiate through the unrolled sweeps.",
    )
    # final posterior and evidence from the converged sites
    mu, sig2, Lb = _posterior_from_sites(K, nu, tau, jitter)
    site_sum, sig2 = _site_terms(loglik_fn, mu, sig2, nu, tau, deg, c)
    logdetB = 2.0 * torch.sum(torch.log(torch.diagonal(Lb, dim1=-2, dim2=-1)))
    log_marginal = site_sum - 0.5 * logdetB + 0.5 * torch.sum(nu * mu)
    return EPResult(
        f_mean=mu[:, None], f_var=sig2[:, None], log_marginal=log_marginal,
        nu=nu, tau=tau, delta=d,
    )


def _floored(P):
    """P + floor * I with the Laplace engine's scale-aware floor,
    1e-6 (1 + P's largest diagonal entry), its gradient stopped.

    The JAX package scales this floor by the jitter level (1e-4) instead.
    At n = 1e5 that floor is ~0.1-1 on P's unit eigenvalues: it lowers the
    evidence by ~21 nats (SparseGPC at its initial weights), it grows with
    k_var, and its stopped gradient then points away from the evidence's
    (Adam lowers the evidence it ascends). At the Laplace engine's 1e-6 the
    evidence is within 0.04 nats of the Laplace one there and training
    rises (``python -m henbun_tpu_torch.utils.ep_floor`` measures both)."""
    return _with_floor(P)


def _projected_posterior(A, AT, Im, nu, tau, jitter):
    """(mu [n], sig2 [n], Lp [m, m], half [m, 1]) from the m-dim
    representation P = I + A^T T A."""
    AtTA, Atnu = row_sum(matmul_hp(AT * tau[None, :], A), matmul_hp(AT, nu[:, None]))
    P = Im + AtTA
    Lp = safe_cholesky(_floored(P), jitter)
    V = tri_solve(Lp, AT)  # [m, n]; sig2_i = colnorm^2
    sig2 = torch.sum(torch.square(V), dim=0)
    half = tri_solve(Lp, Atnu)
    mu = matmul_hp(V.mT, half)[:, 0]
    return mu, sig2, Lp, half


def ep_gp_projected(loglik_fn, A, sweeps=30, damping=0.5, jitter=None,
                    deg=20, tau_cav_floor=1e-6, implicit_diff=True,
                    delta_tol=1e-2):
    """Parallel EP for the projected (inducing-point) prior f = A v,
    v ~ N(0, I_m), A [n, m]: the sparse counterpart of :func:`ep_gp`.

    The same moment matching with the rank-m prior K = A A^T: each sweep
    factorizes the m x m precision P = I + A^T T A (Sylvester:
    log|I_n + sqrtT K sqrtT| = log|P|, and nu^T Sigma_f nu =
    (A^T nu)^T P^-1 (A^T nu)), so the evidence formula carries over
    exactly: with z = X this reproduces ep_gp. Cost per sweep
    O(n m^2 + m^3). Same diagnostic and training guard as ep_gp.

    Returns an :class:`EPResult`; ``f_mean``/``f_var`` are the training
    marginals under the projected prior (no residual variance: add the
    FITC diagonal downstream for prediction, as
    ``SparseGPC.predict_p_ep`` does).
    """
    if jitter is None:
        jitter = settings.numerics.jitter_level
    Im = eye(A.shape[-1], A.dtype, A.device)
    AT = A.mT
    c = _Floors(A, tau_cav_floor)
    nu, tau, d = _run_sweeps(
        lambda nu_, tau_: _projected_posterior(A, AT, Im, nu_, tau_, jitter),
        loglik_fn, A, sweeps, damping, deg, c, implicit_diff, delta_tol,
        _GUARD_HINT
        + " Raise sweeps, lower damping, raise delta_tol if the"
        " residual is acceptable, or pass implicit_diff=False.",
    )
    mu, sig2, Lp, half = _projected_posterior(A, AT, Im, nu, tau, jitter)
    site_sum, sig2 = _site_terms(loglik_fn, mu, sig2, nu, tau, deg, c)
    logdetP = 2.0 * torch.sum(torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1)))
    # 0.5 nu^T Sigma_f nu = 0.5 ||Lp^-1 A^T nu||^2
    log_marginal = site_sum - 0.5 * logdetP + 0.5 * torch.sum(torch.square(half))
    return EPResult(
        f_mean=mu[:, None], f_var=sig2[:, None], log_marginal=log_marginal,
        nu=nu, tau=tau, delta=d,
    )


def ep_projected_marginals(res, A, Astar, corr_diag, jitter=None):
    """Predictive latent marginals (mean [n*, 1], var [n*, 1]) at new inputs
    under a projected EP posterior `res` for f = A v (see
    :func:`ep_gp_projected`). Astar [n*, m] is the projection at the new
    inputs; corr_diag [n*] restores the residual (FITC) prior variance.

        E[f*] = Astar P^-1 A^T nu,  V[f*] = colnorm(Lp^-1 Astar^T)^2 + corr
    """
    if jitter is None:
        jitter = settings.numerics.jitter_level
    m = A.shape[-1]
    AT = A.mT
    P = eye(m, A.dtype, A.device) + matmul_hp(AT * res.tau[None, :], A)
    Lp = safe_cholesky(_floored(P), jitter)
    half = tri_solve(Lp, matmul_hp(AT, res.nu[:, None]))  # [m, 1]
    G = tri_solve(Lp, Astar.mT)  # [m, n*]
    mean = matmul_hp(G.mT, half)  # [n*, 1]
    var = (torch.sum(torch.square(G), dim=0) + corr_diag)[:, None]
    return mean, var


def ep_latent_marginals(res, K, Ks, kdiag, jitter=None):
    """Predictive latent marginals (mean [n*, 1], var [n*, 1]) at new inputs
    under the EP posterior `res` for prior covariance K (GPML 3.60-3.61 in
    natural parameters):

        E[f*]  = Ks^T (nu - sqrtW B^-1 sqrtW K nu)
        V[f*]  = kdiag - colnorm(Lb^-1 sqrtW Ks)^2

    Ks: cross covariance cov(f, f*) [n, n*]; kdiag: prior variances at the
    new inputs [n*]. Variances are clamped at 0 (float32 cancellation at
    near-duplicate inputs, as ``laplace_latent_marginals``)."""
    if jitter is None:
        jitter = settings.numerics.jitter_level
    n = K.shape[-1]
    sw = torch.sqrt(res.tau + 1e-12)
    B = eye(n, K.dtype, K.device) + sw[:, None] * K * sw[None, :]
    Lb = safe_cholesky(B, jitter)
    z = tri_solve(Lb, sw[:, None] * matmul_hp(K, res.nu[:, None]))
    half = tri_solve(Lb, sw[:, None] * Ks)  # [n, n*]
    # the L^T solve takes the solve dispatch (K2 for a fleet), like the
    # forward solves
    alpha = res.nu[:, None] - sw[:, None] * tri_solve_T(Lb, z)
    mean = matmul_hp(Ks.mT, alpha)  # [n*, 1]
    var = kdiag - torch.sum(torch.square(half), dim=0)
    var = torch.maximum(var, torch.zeros_like(var))[:, None]
    return mean, var
