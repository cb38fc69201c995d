"""Hamiltonian Monte Carlo with dual-averaging step-size adaptation and
diagonal mass-matrix (Welford) adaptation, vectorized over chains.

All chains advance together: each leapfrog step is one batched evaluation
of the log density and its gradient over the chains
(``logprob.batched_value_and_grad``). The per-iteration leapfrog counts
are drawn for the whole run up front, the accept step is a
``torch.where`` on the device (a NaN energy counts as -inf), and nothing
is read back to the host until the run ends.

Warmup adapts each chain's step size toward a target accept rate (dual
averaging, Hoffman & Gelman 2014) and estimates per-dimension posterior
variances for the mass matrix; sampling runs with both frozen.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.chains import ChainShard
from .logprob import batched_value_and_grad, make_generator


class HMCResult(NamedTuple):
    samples: torch.Tensor       # [num_samples, num_chains, dim]
    accept_prob: torch.Tensor   # [num_samples, num_chains]
    step_size: torch.Tensor     # [num_chains]
    inv_mass: torch.Tensor      # [num_chains, dim]
    final_logp: torch.Tensor    # [num_chains]


class _DAState(NamedTuple):
    """Dual averaging (Hoffman & Gelman 2014, Algorithm 5)."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps0):
    # log_eps_bar starts at log(eps0), so a run with num_warmup=0 uses the
    # requested step size (the first update overwrites it: eta_1 = 1)
    return _DAState(
        log_eps=torch.log(eps0),
        log_eps_bar=torch.log(eps0),
        h_bar=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
        count=torch.zeros_like(eps0),
    )


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(count) / gamma * h_bar
    eta = count ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, state.mu, count)


def _leapfrog(vg, theta, mom, grad, eps, inv_mass, num_steps):
    """`num_steps` leapfrog steps with diagonal mass from (theta, mom) and
    the gradient at theta; eps [C, 1] or a scalar. Returns (theta, mom,
    logp, grad) at the end point (logp None when num_steps is 0). One
    batched evaluation a step: the end point's gradient starts the next."""
    logp = None
    for _ in range(int(num_steps)):
        mom = mom + 0.5 * eps * grad
        theta = theta + eps * inv_mass * mom
        logp, grad = vg(theta)
        mom = mom + 0.5 * eps * grad
    return theta, mom, logp, grad


def _transition(vg, theta, logp, grad, z, u, eps, inv_mass, num_steps):
    """One HMC transition for every chain from standard-normal draws z
    [C, dim] (the momentum is z / sqrt(inv_mass)) and uniforms u [C]: a
    proposal is accepted where u < min(1, exp(log_accept)), a NaN
    log_accept counting as -inf. Returns (theta, logp, grad,
    accept_prob)."""
    eps_ = eps[:, None] if eps.ndim == 1 else eps
    mom = z / torch.sqrt(inv_mass)
    theta_new, mom_new, logp_new, grad_new = _leapfrog(
        vg, theta, mom, grad, eps_, inv_mass, num_steps
    )
    ke = 0.5 * torch.sum(inv_mass * mom**2, dim=-1)
    ke_new = 0.5 * torch.sum(inv_mass * mom_new**2, dim=-1)
    log_accept = (logp_new - ke_new) - (logp - ke)
    log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = u < accept_prob
    theta = torch.where(accept[:, None], theta_new, theta)
    grad = torch.where(accept[:, None], grad_new, grad)
    logp = torch.where(accept, logp_new, logp)
    return theta, logp, grad, accept_prob


def _step_counts(g, n, num_leapfrog, jitter_steps, device):
    """Leapfrog counts of n iterations, drawn at once (one host read a
    run): uniform in [num_leapfrog / 2, num_leapfrog], shared by the
    chains."""
    if not jitter_steps or num_leapfrog <= 2:
        return [int(num_leapfrog)] * n
    lo = max(num_leapfrog // 2, 1)
    return torch.randint(lo, num_leapfrog + 1, (n,), generator=g, device=device).tolist()


def sample(log_prob, init, generator=None, num_samples=1000, num_warmup=500,
           num_leapfrog=16, initial_step_size=0.1, target_accept=0.8,
           adapt_mass=True, jitter_steps=True, mesh=None, thin=1):
    """Run HMC on `log_prob` (theta [dim] -> scalar).

    - init: [num_chains, dim] initial positions (chain count inferred);
      the chains run on its device.
    - generator: a torch.Generator on that device, or an int seed (0 when
      None).
    - jitter_steps: draw the leapfrog count uniformly in
      [num_leapfrog / 2, num_leapfrog] each iteration (shared by the
      chains). With a fixed count, a chain whose adapted (eps, mass) lands
      near a leapfrog resonance bounces between +-x forever.
    - mesh: a DeviceMesh (``parallel.make_mesh``): each rank runs its
      block of the chains over the ``chain`` dimension, with the same
      generator seed on every rank (``parallel/chains.py``); the result
      holds every chain on every rank. HMC's chains share nothing, so no
      collective runs before the final gather.

    Returns an HMCResult with samples [num_samples, num_chains, dim].
    """
    init = torch.atleast_2d(torch.as_tensor(init))
    num_chains, dim = init.shape
    sh = ChainShard(mesh, num_chains)
    init = sh.local(init)
    nc = sh.local_n
    dev, dt = init.device, init.dtype
    g = make_generator(generator, dev)
    vg = batched_value_and_grad(log_prob)
    steps = _step_counts(g, num_warmup + num_samples * thin, num_leapfrog, jitter_steps, dev)

    def draws():
        z = torch.randn((num_chains, dim), generator=g, dtype=dt, device=dev)
        u = torch.rand((num_chains,), generator=g, dtype=dt, device=dev)
        return sh.local(z), sh.local(u)

    theta = init
    logp, grad = vg(theta)
    da = _da_init(torch.full((nc,), initial_step_size, dtype=dt, device=dev))
    w_mean = torch.zeros((nc, dim), dtype=dt, device=dev)
    w_m2 = torch.zeros((nc, dim), dtype=dt, device=dev)
    ones = torch.ones_like(w_m2)
    for it in range(int(num_warmup)):
        count = float(it)
        inv_mass_now = (w_m2 / max(count - 1.0, 1.0)
                        if adapt_mass and count > 10.0 else ones)
        theta, logp, grad, accept_prob = _transition(
            vg, theta, logp, grad, *draws(), torch.exp(da.log_eps), inv_mass_now, steps[it]
        )
        da = _da_update(da, accept_prob, target=target_accept)
        # Welford accumulation of per-dimension variance for the mass matrix
        count = count + 1.0
        delta = theta - w_mean
        w_mean = w_mean + delta / count
        w_m2 = w_m2 + delta * (theta - w_mean)
    eps = torch.exp(da.log_eps_bar)
    if adapt_mass:
        var = w_m2 / max(float(num_warmup) - 1.0, 1.0)
        inv_mass = torch.where(var > 0, var, 1.0)
    else:
        inv_mass = ones
    samples, accepts = [], []
    for it in range(int(num_samples) * int(thin)):
        theta, logp, grad, accept_prob = _transition(
            vg, theta, logp, grad, *draws(), eps, inv_mass, steps[num_warmup + it]
        )
        if (it + 1) % thin == 0:
            samples.append(theta)
            accepts.append(accept_prob)
    return HMCResult(sh.gather(_stack(samples, (0, nc, dim), theta), 1),
                     sh.gather(_stack(accepts, (0, nc), logp), 1), sh.gather(eps),
                     sh.gather(inv_mass), sh.gather(logp))


def _stack(rows, empty_shape, like):
    if not rows:
        return torch.empty(empty_shape, dtype=like.dtype, device=like.device)
    return torch.stack(rows)


def effective_sample_size(samples):
    """ESS per dimension (per-chain initial-positive-sequence estimator,
    summed over chains); see ``diagnostics.effective_sample_size``.
    samples: [n, num_chains, dim] -> [dim]."""
    from . import diagnostics

    return diagnostics.effective_sample_size(_host(samples))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
