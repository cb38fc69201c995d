"""Sequential Monte Carlo: adaptive-tempered SMC with systematic
resampling and HMC move kernels.

Adaptive tempering: beta goes from 0 to 1 in steps chosen by bisection so
the incremental-weight ESS stays at `target_ess` * P; systematic
resampling; K HMC moves targeting p(theta) L(theta)^beta per stage; the
log-evidence accumulates from the incremental weights.

Everything inside a stage stays on the device: the ESS bisection is 30
tensor steps, resampling is a cumulative sum and ``torch.searchsorted``
against one uniform, and the moves are batched leapfrogs over all
particles. The stage loop reads beta back once a stage to decide whether
to go on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.chains import ChainShard
from .logprob import batched_value_and_grad, make_generator


class SMCResult(NamedTuple):
    particles: torch.Tensor     # [P, dim] final (equal-weight) particles
    log_evidence: torch.Tensor  # scalar estimate of log Z
    num_stages: int             # tempering stages used
    final_beta: torch.Tensor


def _ess(log_w):
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * log_w, dim=0))


def _systematic_index(generator, log_w, u0=None):
    """The source index of each of the P resampled particles."""
    n = log_w.shape[0]
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    cdf = torch.cumsum(w, dim=0)
    if u0 is None:
        u0 = torch.rand((), generator=generator, dtype=w.dtype, device=w.device)
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.clamp(torch.searchsorted(cdf, pts), 0, n - 1)


def systematic_resample(generator, log_w, particles, u0=None):
    """Systematic resampling: one uniform u0 (drawn from `generator` unless
    given), P evenly spaced CDF lookups by ``torch.searchsorted``."""
    return particles[_systematic_index(generator, log_w, u0)]


def _find_next_beta(beta, log_lik, target_ess_frac, n_bisect=30):
    """Largest delta in (0, 1 - beta] with ESS(delta * log_lik) >= target,
    by `n_bisect` bisection steps on the device."""
    target = target_ess_frac * log_lik.shape[0]
    full = 1.0 - beta
    lo, hi = torch.zeros_like(beta), full
    for _ in range(int(n_bisect)):
        mid = 0.5 * (lo + hi)
        ok = _ess(mid * log_lik) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # if even the full step keeps the ESS above target, jump straight to 1
    delta = torch.where(_ess(full * log_lik) >= target, full, lo)
    return torch.clamp(delta, min=1e-5)


def sample_model(model, prior_method, likelihood_method, num_particles, generator=None,
                 collection=None, init_scale=1.0, **kwargs):
    """SMC over a model tree: `prior_method` / `likelihood_method` are model
    objectives (names or methods) returning log p(theta) and log p(y |
    theta). Transform log-Jacobians attach to the prior (they belong to the
    measure); particles start overdispersed around the model's current
    free values. Returns (SMCResult, FlatLogProb): flp.unravel /
    set_model_state map particles back to the tree."""
    from .logprob import make_log_prob

    flp_prior = make_log_prob(model, prior_method, collection, add_transform_jacobians=True)
    flp_lik = make_log_prob(model, likelihood_method, collection, add_transform_jacobians=False)
    init = flp_prior.initial
    g = make_generator(generator, init.device)
    particles = init + init_scale * torch.randn(
        (int(num_particles), flp_prior.dim), generator=g, dtype=init.dtype, device=init.device
    )
    res = sample(flp_prior.log_prob, flp_lik.log_prob, particles, g, **kwargs)
    return res, flp_prior


def sample(log_prior, log_likelihood, init_particles, generator=None, num_move_steps=5,
           num_leapfrog=8, step_size=0.1, target_ess=0.5, max_stages=100, mesh=None):
    """Adaptive-tempered SMC from prior samples to the posterior.

    - log_prior, log_likelihood: theta [dim] -> scalar (the posterior is
      prior * likelihood; tempering applies to the likelihood).
    - init_particles: [P, dim] draws from the prior; the particles live on
      its device.
    - generator: a torch.Generator on that device, or an int seed.
    - mesh: a DeviceMesh whose ``chain`` dimension splits the particles
      (``parallel/chains.py``): each rank moves its block; a stage
      all-gathers the log-likelihoods (the ESS bisection, the evidence and
      the resampling draw then run on all P on every rank), the [P, dim]
      particles the resampled block is taken from (the block's densities
      and gradients are then evaluated anew) and each particle's count of
      accepted moves: P (dim + 2) floats a stage, whatever the moves.
    Returns SMCResult (particles are equal-weight after the final stage),
    every particle on every rank.
    """
    particles = torch.as_tensor(init_particles)
    P_, dim = particles.shape
    sh = ChainShard(mesh, P_)
    particles = sh.local(particles)
    dt, dev = particles.dtype, particles.device
    g = make_generator(generator, dev)
    vg_prior = batched_value_and_grad(log_prior)
    vg_lik = batched_value_and_grad(log_likelihood)

    def move(theta, lp_pr, g_pr, lp_lik, g_lik, beta, eps):
        """One HMC transition of every particle targeting the tempered
        density (unit mass); returns the new state and the accept flags."""
        r0 = sh.local(torch.randn((P_, dim), generator=g, dtype=dt, device=dev))
        logp0 = lp_pr + beta * lp_lik
        th, r = theta, r0
        gp, gl, pp, pl = g_pr, g_lik, lp_pr, lp_lik
        for _ in range(int(num_leapfrog)):
            r = r + 0.5 * eps * (gp + beta * gl)
            th = th + eps * r
            pp, gp = vg_prior(th)
            pl, gl = vg_lik(th)
            r = r + 0.5 * eps * (gp + beta * gl)
        logp1 = pp + beta * pl
        log_acc = (logp1 - 0.5 * torch.sum(r**2, -1)) - (logp0 - 0.5 * torch.sum(r0**2, -1))
        log_acc = torch.where(torch.isnan(log_acc), -torch.inf, log_acc)
        u = sh.local(torch.rand((P_,), generator=g, dtype=dt, device=dev))
        acc = torch.log(u) < log_acc
        a1 = acc[:, None]
        return (torch.where(a1, th, theta), torch.where(acc, pp, lp_pr),
                torch.where(a1, gp, g_pr), torch.where(acc, pl, lp_lik),
                torch.where(a1, gl, g_lik)), acc

    beta = torch.zeros((), dtype=dt, device=dev)
    log_Z = torch.zeros((), dtype=dt, device=dev)
    eps = torch.tensor(step_size, dtype=torch.float32, device=dev)
    log_P = math.log(P_ * 1.0)
    n_stages = 0
    # (particles, log prior, its gradient, log likelihood, its gradient):
    # the moves carry every term from one move to the next; after the
    # resampling the block's terms are evaluated anew, so a stage exchanges
    # the particles only
    state = (particles,) + vg_prior(particles) + vg_lik(particles)
    while n_stages < max_stages and float(beta) < 1.0 - 1e-6:  # one host read a stage
        (lp_lik,) = sh.gather_rows(state[3])
        delta = _find_next_beta(beta, lp_lik, target_ess)
        log_w = delta * lp_lik
        # evidence increment: log mean of the incremental weights
        log_Z = log_Z + torch.logsumexp(log_w, dim=0) - log_P
        beta = beta + delta
        idx = sh.local(_systematic_index(g, log_w))
        theta = sh.gather(state[0])[idx]
        state = (theta,) + vg_prior(theta) + vg_lik(theta)
        accepted = torch.zeros(sh.local_n, dtype=torch.float32, device=dev)
        for _ in range(int(num_move_steps)):
            state, acc = move(*state, beta, eps)
            accepted = accepted + acc.to(torch.float32)
        # the accept counts are whole numbers, so their sum is exact in any
        # order: every rank and one process read the same rate
        (accepted,) = sh.gather_rows(accepted)
        # per-stage step-size adaptation: the tempered target sharpens as
        # beta grows; nudge eps toward ~0.65 accept (Robbins-Monro style)
        acc_rate = torch.sum(accepted) / (P_ * num_move_steps)
        eps = torch.clamp(eps * torch.exp(0.5 * (acc_rate - 0.65)), step_size * 1e-3,
                          step_size * 1e3)
        n_stages += 1
    return SMCResult(sh.gather(state[0]), log_Z, n_stages, beta)
