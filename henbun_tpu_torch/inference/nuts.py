"""No-U-Turn Sampler: iterative multinomial NUTS with a depth budget, the
chains in lockstep.

The trajectory of up to 2^max_tree_depth leapfrog steps is built by
doublings, with the full set of recursive-NUTS U-turn checks reproduced by
an O(max_depth) checkpoint scheme:

* leaves of a size-2^d subtree are indexed i = 0..2^d-1 in integration
  order;
* a size-2^k sub-subtree ends at leaf i iff the last k bits of i are ones,
  and its left endpoint is i with those bits zeroed;
* storing each even leaf at checkpoint slot popcount(i) makes the left
  endpoints needed at odd leaf i occupy the contiguous slots
  [popcount(i)-K .. popcount(i)-1], K = trailing ones of i.

Proposals use multinomial sampling within subtrees and biased progressive
sampling across doublings, as Stan does.

Lockstep form: torch cannot vmap a data-dependent loop, so all chains step
together and each carries an active mask. A leaf index i is the same for
every chain, so the checkpoint slots are host integers. A doubling's
subtree runs its 2^depth leaves for every chain at once, one batched
evaluation a leaf; a chain that turns or diverges inside it stops moving
(its updates are masked) while the others finish. The doubling loop reads
one flag back to the host, "is any chain still building", before each
doubling after the first: at most max_tree_depth - 1 reads a draw, none a
leapfrog. A draw so costs the deepest chain's doublings, as a vmapped
while loop does, except that the last doubling always runs to its end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hmc import _da_init, _da_update, _stack
from ..parallel.chains import ChainShard
from .logprob import batched_value_and_grad, make_generator


class NUTSResult(NamedTuple):
    samples: torch.Tensor      # [num_samples, num_chains, dim]
    accept_prob: torch.Tensor  # [num_samples, num_chains] (mean MH stat)
    num_steps: torch.Tensor    # [num_samples, num_chains] leapfrog steps taken
    step_size: torch.Tensor    # [num_chains]
    inv_mass: torch.Tensor     # [num_chains, dim]
    final_logp: torch.Tensor   # [num_chains]


def _popcount(x):
    return bin(int(x)).count("1")


def _trailing_ones(x):
    x = int(x)
    return _popcount(x ^ (x + 1)) - 1


def _is_turning(theta_minus, r_minus, theta_plus, r_plus, inv_mass):
    """Generalized U-turn criterion with diagonal mass (velocity form),
    over the last axis."""
    dtheta = theta_plus - theta_minus
    return torch.logical_or(
        torch.sum(dtheta * (inv_mass * r_minus), -1) < 0,
        torch.sum(dtheta * (inv_mass * r_plus), -1) < 0,
    )


class _Tree(NamedTuple):
    theta_prop: torch.Tensor   # multinomial proposal from the subtree
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_sum_weight: torch.Tensor
    theta_last: torch.Tensor   # subtree endpoint in integration order
    r_last: torch.Tensor
    grad_last: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor   # sum of min(1, exp(H0 - H)) over leaves
    n_leaves: torch.Tensor


def _build_subtree(vg, depth, theta0, r0, grad0, eps_signed, inv_mass, energy0,
                   max_depth, active, g, sh):
    """Integrate 2^depth leapfrog steps from (theta0, r0) for every chain,
    with checkpointed U-turn checks; a chain stops (its state frozen) at
    its first turning or diverging leaf, or where `active` is off."""
    C, dim = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    ckpt_theta = torch.zeros((C, max_depth + 1, dim), dtype=dt, device=dev)
    ckpt_r = torch.zeros_like(ckpt_theta)
    theta, r, grad = theta0, r0, grad0
    theta_prop, grad_prop = theta0, grad0
    logp_prop = torch.zeros((C,), dtype=dt, device=dev)
    lsw = torch.full((C,), -torch.inf, dtype=dt, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros((C,), dtype=dt, device=dev)
    n_leaves = torch.zeros((C,), dtype=torch.int32, device=dev)
    eps_ = eps_signed[:, None]
    for i in range(2**depth):
        go = active & ~turning & ~diverging
        go_ = go[:, None]
        # one leapfrog step
        r_half = r + 0.5 * eps_ * grad
        th = theta + eps_ * inv_mass * r_half
        lp, gr = vg(th)
        rr = r_half + 0.5 * eps_ * gr
        energy = -lp + 0.5 * torch.sum(inv_mass * rr**2, -1)
        delta = energy0 - energy  # log weight of this leaf
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        # progressive multinomial proposal within the subtree
        lsw_new = torch.logaddexp(lsw, delta)
        u = sh.local(torch.rand((sh.n,), generator=g, dtype=dt, device=dev))
        take = go & (torch.log(u) < delta - lsw_new)
        theta_prop = torch.where(take[:, None], th, theta_prop)
        grad_prop = torch.where(take[:, None], gr, grad_prop)
        logp_prop = torch.where(take, lp, logp_prop)
        # checkpoint scheme: even leaves store, odd leaves check
        pc = _popcount(i)
        turn = torch.zeros_like(turning)
        if i % 2 == 0:
            ckpt_theta[:, pc] = torch.where(go_, th, ckpt_theta[:, pc])
            ckpt_r[:, pc] = torch.where(go_, rr, ckpt_r[:, pc])
        else:
            for k in range(1, _trailing_ones(i) + 1):
                turn = turn | _is_turning(ckpt_theta[:, pc - k], ckpt_r[:, pc - k], th, rr,
                                          inv_mass)
        theta = torch.where(go_, th, theta)
        r = torch.where(go_, rr, r)
        grad = torch.where(go_, gr, grad)
        lsw = torch.where(go, lsw_new, lsw)
        sum_accept = torch.where(go, sum_accept + torch.clamp(torch.exp(delta), max=1.0),
                                 sum_accept)
        turning = torch.where(go, turn, turning)
        diverging = torch.where(go, delta < -1000.0, diverging)
        n_leaves = n_leaves + go.to(torch.int32)
    return _Tree(theta_prop, logp_prop, grad_prop, lsw, theta, r, grad, turning, diverging,
                 sum_accept, n_leaves)


def _transition(vg, theta, logp, grad, eps, inv_mass, max_tree_depth, g, sh):
    """One NUTS transition of every chain of this rank (sh: its block of
    the chains, ``parallel/chains.py``); eps [C], inv_mass [C, dim].
    Returns (theta, logp, grad, accept_stat, n_leapfrog)."""
    C, dim = theta.shape
    dt, dev = theta.dtype, theta.device
    z = sh.local(torch.randn((sh.n, dim), generator=g, dtype=dt, device=dev))
    r0 = z / torch.sqrt(inv_mass)
    energy0 = -logp + 0.5 * torch.sum(inv_mass * r0**2, -1)
    s = dict(
        theta_prop=theta, logp_prop=logp, grad_prop=grad,
        log_sum_weight=torch.zeros((C,), dtype=dt, device=dev),  # the initial leaf's exp(0)
        # trajectory endpoints: minus (backward in time) and plus (forward)
        theta_minus=theta, r_minus=r0, grad_minus=grad,
        theta_plus=theta, r_plus=r0, grad_plus=grad,
        turning=torch.zeros((C,), dtype=torch.bool, device=dev),
        diverging=torch.zeros((C,), dtype=torch.bool, device=dev),
        sum_accept=torch.zeros((C,), dtype=dt, device=dev),
        n_leapfrog=torch.zeros((C,), dtype=torch.int32, device=dev),
    )
    for depth in range(int(max_tree_depth)):
        active = ~(s["turning"] | s["diverging"])
        if depth > 0 and not bool(sh.any(active.any())):  # one host read a doubling
            break
        go_right = sh.local(torch.rand((sh.n,), generator=g, dtype=dt, device=dev)) < 0.5
        right = go_right[:, None]
        tree = _build_subtree(
            vg, depth,
            torch.where(right, s["theta_plus"], s["theta_minus"]),
            torch.where(right, s["r_plus"], s["r_minus"]),
            torch.where(right, s["grad_plus"], s["grad_minus"]),
            torch.where(go_right, eps, -eps), inv_mass, energy0, int(max_tree_depth),
            active, g, sh,
        )
        ok = ~(tree.turning | tree.diverging)
        # biased progressive sampling across the doubling
        u = sh.local(torch.rand((sh.n,), generator=g, dtype=dt, device=dev))
        take = ok & (torch.log(u) < tree.log_sum_weight - s["log_sum_weight"])
        new = dict(
            theta_prop=torch.where(take[:, None], tree.theta_prop, s["theta_prop"]),
            logp_prop=torch.where(take, tree.logp_prop, s["logp_prop"]),
            grad_prop=torch.where(take[:, None], tree.grad_prop, s["grad_prop"]),
            log_sum_weight=torch.where(
                ok, torch.logaddexp(s["log_sum_weight"], tree.log_sum_weight),
                s["log_sum_weight"]),
        )
        # endpoints move only when the subtree is usable
        left_ok, right_ok = (ok & ~go_right)[:, None], (ok & go_right)[:, None]
        for key, last in (("theta", tree.theta_last), ("r", tree.r_last),
                          ("grad", tree.grad_last)):
            new[key + "_minus"] = torch.where(left_ok, last, s[key + "_minus"])
            new[key + "_plus"] = torch.where(right_ok, last, s[key + "_plus"])
        # U-turn across the merged trajectory
        new["turning"] = tree.turning | _is_turning(
            new["theta_minus"], new["r_minus"], new["theta_plus"], new["r_plus"], inv_mass)
        new["diverging"] = tree.diverging
        new["sum_accept"] = s["sum_accept"] + tree.sum_accept
        new["n_leapfrog"] = s["n_leapfrog"] + tree.n_leaves
        # a chain that stopped keeps its state
        for key, val in new.items():
            keep = active if val.ndim == 1 else active[:, None]
            s[key] = torch.where(keep, val, s[key])
    accept_stat = s["sum_accept"] / torch.clamp(s["n_leapfrog"].to(dt), min=1.0)
    return s["theta_prop"], s["logp_prop"], s["grad_prop"], accept_stat, s["n_leapfrog"]


def sample(log_prob, init, generator=None, num_samples=1000, num_warmup=500,
           max_tree_depth=8, initial_step_size=0.1, target_accept=0.8,
           adapt_mass=True, adapt_max_depth=True, mesh=None):
    """Run NUTS on `log_prob` (theta [dim] -> scalar).

    init: [num_chains, dim]; generator: a torch.Generator on init's device
    or an int seed; mesh: a DeviceMesh whose ``chain`` dimension splits
    the chains (``parallel/chains.py``): the "is any chain still
    building" flag of a doubling becomes an all-reduce, and the depth
    cap's warmup tree sizes an all-gather. Returns NUTSResult with samples
    [num_samples, num_chains, dim], every chain on every rank.

    adapt_max_depth: in lockstep every chain waits for the deepest tree.
    When True, the second half of warmup records the leapfrog counts the
    chains actually reach, and sampling caps the depth at that
    distribution's 90th percentile + 1 (clipped to [2, max_tree_depth]). A
    depth cap never biases NUTS: the budgeted kernel is a valid (truncated)
    trajectory sampler either way.
    """
    init = torch.atleast_2d(torch.as_tensor(init))
    num_chains, dim = init.shape
    sh = ChainShard(mesh, num_chains)
    init = sh.local(init)
    nc = sh.local_n
    dev, dt = init.device, init.dtype
    g = make_generator(generator, dev)
    vg = batched_value_and_grad(log_prob)

    theta = init
    logp, grad = vg(theta)
    da = _da_init(torch.full((nc,), initial_step_size, dtype=dt, device=dev))
    w_mean = torch.zeros((nc, dim), dtype=dt, device=dev)
    w_m2 = torch.zeros((nc, dim), dtype=dt, device=dev)
    ones = torch.ones_like(w_m2)
    warm_nsteps = []
    for it in range(int(num_warmup)):
        count = float(it)
        inv_mass_now = (w_m2 / max(count - 1.0, 1.0)
                        if adapt_mass and count > 10.0 else ones)
        theta, logp, grad, accept, nsteps = _transition(
            vg, theta, logp, grad, torch.exp(da.log_eps), inv_mass_now, max_tree_depth, g, sh
        )
        da = _da_update(da, accept, target=target_accept)
        count = count + 1.0
        delta = theta - w_mean
        w_mean = w_mean + delta / count
        w_m2 = w_m2 + delta * (theta - w_mean)
        warm_nsteps.append(nsteps)
    eps = torch.exp(da.log_eps_bar)
    if adapt_mass:
        var = w_m2 / max(float(num_warmup) - 1.0, 1.0)
        inv_mass = torch.where(var > 0, var, 1.0)
    else:
        inv_mass = ones

    depth = int(max_tree_depth)
    if adapt_max_depth and num_warmup >= 20:
        # second-half warmup tree sizes -> the depth the chains actually
        # use; nsteps ~ 2^d - 1 at a depth-d U-turn
        tail = sh.gather(torch.stack(warm_nsteps[num_warmup // 2:]), 1).cpu().numpy()
        q90 = float(np.quantile(tail, 0.9))
        depth = int(np.clip(int(np.ceil(np.log2(q90 + 1.0))) + 1, 2, max_tree_depth))

    samples, accepts, steps = [], [], []
    for _ in range(int(num_samples)):
        theta, logp, grad, accept, nsteps = _transition(
            vg, theta, logp, grad, eps, inv_mass, depth, g, sh
        )
        samples.append(theta)
        accepts.append(accept)
        steps.append(nsteps)
    return NUTSResult(
        sh.gather(_stack(samples, (0, nc, dim), theta), 1),
        sh.gather(_stack(accepts, (0, nc), logp), 1),
        sh.gather(_stack(steps, (0, nc), logp).to(torch.int32), 1), sh.gather(eps),
        sh.gather(inv_mass), sh.gather(logp),
    )
