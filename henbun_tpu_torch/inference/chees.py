"""ChEES-HMC: adaptive-trajectory-length HMC for SIMD hardware.

NUTS's per-chain dynamic trees run in lockstep across chains: every chain
waits for the deepest tree each iteration. ChEES-HMC (Hoffman, Radul &
Sountsov 2021) replaces the U-turn recursion with one shared trajectory
length, adapted by maximizing the Change in the Estimator of the Expected
Square criterion

    ChEES = E[ (||theta' - m||^2 - ||theta - m||^2)^2 ] / 4

(m = cross-chain mean). All chains run the same jittered number of
leapfrog steps each iteration, one batched evaluation a step. Step size
adapts by dual averaging on the cross-chain mean accept rate, the
trajectory length by Adam on log T with the paper's gradient estimator.

The leapfrog count of an iteration, ceil(halton(it) T / eps), depends on
the adapted T and eps, so warmup reads it back to the host once an
iteration; sampling reads T and eps once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .hmc import _da_init, _da_update, _leapfrog, _stack
from ..parallel.chains import ChainShard
from .logprob import batched_value_and_grad, make_generator


class ChEESResult(NamedTuple):
    samples: torch.Tensor            # [num_samples, num_chains, dim]
    accept_prob: torch.Tensor        # [num_samples, num_chains]
    step_size: torch.Tensor          # scalar (shared across chains)
    trajectory_length: torch.Tensor  # scalar, adapted
    inv_mass: torch.Tensor           # [dim] (shared)
    final_logp: torch.Tensor         # [num_chains]


def _halton(i):
    """Van der Corput (Halton base 2) point i in (0, 1) from 16 binary
    digits of i + 1; exact in float32."""
    i = int(i) + 1
    return sum(((i >> k) & 1) / 2.0 ** (k + 1) for k in range(16))


def _steps_from(traj, eps, it, max_leapfrog):
    """ceil(halton(it) T / eps), clipped to [1, max_leapfrog], on the
    device in T's float type (as the JAX package computes it; the Halton
    point is exact in float32, so no constant is copied to the device)."""
    n = torch.ceil(traj * _halton(it) / eps).to(torch.int32)
    return torch.clamp(n, 1, int(max_leapfrog))


def _adam_update(state, g, x, lr):
    m, v, t = state
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    t = t + 1.0
    mh = m / (1 - 0.9**t)
    vh = v / (1 - 0.999**t)
    return (m, v, t), x + lr * mh / (torch.sqrt(vh) + 1e-8)


def _traj_gradient(theta, theta_prop, vel_prop, accept, traj):
    """The ChEES gradient with respect to log T (paper eq. 14-15,
    accept-weighted), squashed to |g| < 1. Divergent proposals carry
    non-finite positions with accept ~ 0: they are masked before any
    product (0 * inf = nan would poison log T for good)."""
    finite = torch.all(torch.isfinite(theta_prop), dim=-1)
    safe_prop = torch.where(finite[:, None], theta_prop, theta)
    safe_vel = torch.where(finite[:, None], vel_prop, 0.0)
    m_bar = torch.mean(safe_prop, dim=0)
    d_new = safe_prop - m_bar
    d_old = theta - m_bar
    crit = torch.sum(d_new**2, -1) - torch.sum(d_old**2, -1)  # [chains]
    dir_term = torch.sum(d_new * safe_vel, -1)
    w = torch.where(finite, accept, 0.0)
    g = torch.sum(w * crit * dir_term) / torch.clamp(torch.sum(w), min=1e-6)
    g_log = g * traj
    return torch.where(torch.isfinite(g_log), g_log / (1.0 + torch.abs(g_log)), 0.0)


def _chain_step(vg, theta, logp, grad, z, u, eps, inv_mass, n_steps):
    """One ChEES transition of every chain (shared eps and inv_mass) from
    standard-normal draws z and uniforms u: accepted where
    log(u) < log_accept. Returns (theta, logp, grad, accept_prob,
    proposal, proposal velocity)."""
    r0 = z / torch.sqrt(inv_mass)
    theta_new, r_new, logp_new, grad_new = _leapfrog(vg, theta, r0, grad, eps, inv_mass, n_steps)
    ke0 = 0.5 * torch.sum(inv_mass * r0**2, -1)
    ke1 = 0.5 * torch.sum(inv_mass * r_new**2, -1)
    log_acc = (logp_new - ke1) - (logp - ke0)
    log_acc = torch.where(torch.isnan(log_acc), -torch.inf, log_acc)
    accept_prob = torch.clamp(torch.exp(log_acc), max=1.0)
    accept = torch.log(u) < log_acc
    theta_out = torch.where(accept[:, None], theta_new, theta)
    grad_out = torch.where(accept[:, None], grad_new, grad)
    logp_out = torch.where(accept, logp_new, logp)
    return theta_out, logp_out, grad_out, accept_prob, theta_new, inv_mass * r_new


def sample(log_prob, init, generator=None, num_samples=1000, num_warmup=500,
           initial_step_size=0.1, initial_traj_length=1.0, target_accept=0.75,
           max_leapfrog=256, adapt_mass=True, traj_learning_rate=0.025, mesh=None):
    """Run ChEES-HMC on `log_prob` (theta [dim] -> scalar).

    init: [num_chains, dim], at least 2 chains (the criterion uses
    cross-chain means); generator: a torch.Generator on init's device or
    an int seed; mesh: a DeviceMesh whose ``chain`` dimension splits the
    chains (``parallel/chains.py``): each warmup iteration gathers the
    per-chain values the cross-chain mean accept rate, the trajectory
    criterion and the pooled mass matrix need, in one all-gather.
    Returns ChEESResult, every chain on every rank."""
    init = torch.atleast_2d(torch.as_tensor(init))
    num_chains, dim = init.shape
    if num_chains < 2:
        raise ValueError("ChEES-HMC needs at least 2 chains")
    sh = ChainShard(mesh, num_chains)
    init = sh.local(init)
    nc = sh.local_n
    dev, dt = init.device, init.dtype
    g = make_generator(generator, dev)
    vg = batched_value_and_grad(log_prob)

    def draws():
        z = torch.randn((num_chains, dim), generator=g, dtype=dt, device=dev)
        u = torch.rand((num_chains,), generator=g, dtype=dt, device=dev)
        return sh.local(z), sh.local(u)

    theta = init
    logp, grad = vg(theta)
    da = _da_init(torch.tensor(initial_step_size, dtype=dt, device=dev))
    log_traj = torch.log(torch.tensor(initial_traj_length, dtype=dt, device=dev))
    zero = torch.zeros((), dtype=dt, device=dev)
    tr_adam = (zero, zero, zero)
    w_mean = torch.zeros((nc, dim), dtype=dt, device=dev)
    w_m2 = torch.zeros((nc, dim), dtype=dt, device=dev)
    w_m2_all = w_m2  # every chain's, as of the last iteration
    ones = torch.ones((dim,), dtype=dt, device=dev)
    lo, hi = torch.log(torch.tensor(1e-2)).item(), torch.log(torch.tensor(1e3)).item()
    for it in range(int(num_warmup)):
        count = float(it)
        eps = torch.exp(da.log_eps)
        traj = torch.exp(log_traj)
        n_steps = int(_steps_from(traj, eps, it, max_leapfrog))  # one host read
        inv_mass_now = (torch.mean(w_m2_all, 0) / max(count - 1.0, 1.0)
                        if adapt_mass and count > 10.0 else ones)
        theta, logp, grad, accept, theta_prop, vel_prop = _chain_step(
            vg, theta, logp, grad, *draws(), eps, inv_mass_now, n_steps
        )
        # Welford for the mass matrix (per chain; pooled over the chains)
        count = count + 1.0
        delta = theta - w_mean
        w_mean = w_mean + delta / count
        w_m2 = w_m2 + delta * (theta - w_mean)
        theta_all, prop_all, vel_all, accept_all, w_m2_all = sh.gather_rows(
            theta, theta_prop, vel_prop, accept, w_m2)
        da = _da_update(da, torch.mean(accept_all), target=target_accept)
        g_log = _traj_gradient(theta_all, prop_all, vel_all, accept_all, traj)
        tr_adam, log_traj = _adam_update(tr_adam, g_log, log_traj, traj_learning_rate)
        log_traj = torch.clamp(log_traj, lo, hi)
    eps = torch.exp(da.log_eps_bar)
    traj = torch.exp(log_traj)
    if adapt_mass:
        var = torch.mean(w_m2_all, 0) / max(float(num_warmup) - 1.0, 1.0)
        inv_mass = torch.where(var > 0, var, 1.0)
    else:
        inv_mass = ones
    # T and eps are frozen: every sampling iteration's count in one read
    n_all = torch.stack([_steps_from(traj, eps, it, max_leapfrog)
                         for it in range(int(num_samples))]).tolist() if num_samples else []
    samples, accepts = [], []
    for it in range(int(num_samples)):
        theta, logp, grad, accept, _, _ = _chain_step(
            vg, theta, logp, grad, *draws(), eps, inv_mass, n_all[it]
        )
        samples.append(theta)
        accepts.append(accept)
    return ChEESResult(sh.gather(_stack(samples, (0, nc, dim), theta), 1),
                       sh.gather(_stack(accepts, (0, nc), logp), 1), eps, traj, inv_mass,
                       sh.gather(logp))
