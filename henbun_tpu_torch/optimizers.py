"""Natural gradients for Gaussian posteriors.

Each trainable :class:`~henbun_tpu_torch.variationals.Variational` node's
(q_mu, q_sqrt) pair is updated in natural-parameter space

    theta1 = Sigma^-1 mu,     theta2 = -1/2 Sigma^-1
    theta <- theta + gamma * dL/d(eta),   eta = (mu, Sigma + mu mu^T)

where dL/d(eta) comes from the ordinary gradients through one VJP of the
eta -> (mu, chol) map. Every other parameter (kernel hyperparameters,
likelihood variances, network weights) goes to a second optimizer, ``rest``
(default ``adam(1e-2)``). For a conjugate model one unit step lands on the
optimal posterior (Salimbeni et al. 2018).

Usage::

    opt.compile(hb.optimizers.natural_gradient(
        model, gamma=0.1, rest=hb.adam(0.01)))

The factory is marked ``henbun_natgrad``: ``Optimizer.compile`` hands it the
``{tree-path: tensor}`` dict, since the pairs are found by their paths
``"<node>.q_mu"`` and ``"<node>.q_sqrt"``.

Factorizations and solves. All fullrank pairs of a step are flattened into
one [N, m, m] stack (N distributions: models x layers), so a fleet's
natural gradient is one batched call per factorization:
``linalg._cholesky_dispatch`` for the two Cholesky factors and
``linalg.tri_solve`` against the identity for the two inverses. On a CUDA
tensor with ``[cuda] use_kernels`` those are the hand-written K1 and K2.
No jitter escalation: a NaN factor is the signal that theta2 left the
positive-definite cone.

The PD-cone retry ladder. A step whose theta2 leaves the cone is retried
at gamma/8, then gamma/64; a distribution keeps its old value only if all
three fail. The JAX package runs the retries in a masked ``while_loop``.
Here the three gammas are stacked along the batch axis, so each
factorization of a step is one launch on [3N, m, m] and each inverse one
more, and the first attempt whose result is finite is chosen per
distribution on the device (``torch.where``): no host read, and the same
outcome as the reference's loop body.

Choosing gamma: gamma = 1 on deterministic conjugate objectives (analytic
expected log-likelihood and ``analytic_kl=True``); 0.1-0.3 on quadrature
objectives; 0.005-0.01 on Monte Carlo objectives, where ``adaptive=True``
turns the ladder into a per-node step-size controller (see
:func:`natural_gradient`).
"""
from __future__ import annotations

import torch

from .model import adam
from .variationals import Variational
from .ops import linalg
from .ops.linalg import fill_triangular, fill_triangular_inverse, matmul_hp

# the retry ladder: gamma, gamma/8, gamma/64
_LADDER = (1.0, 1.0 / 8.0, 1.0 / 64.0)


def _inverse_factor(L):
    """L^-1 for a [B, m, m] stack of lower factors (one batched solve)."""
    m = L.shape[-1]
    eye = torch.eye(m, dtype=L.dtype, device=L.device).expand(L.shape)
    return linalg.tri_solve(L, eye)


def _eta_vjp(mu, L, gmu, gL):
    """(d/d eta1, d/d eta2) of the objective through
    eta -> (eta1, chol(eta2 - eta1 eta1^T)) at eta = (mu, L L^T + mu mu^T),
    the cotangent being (gmu, tril(gL)). The factor's backward is
    torch.linalg's own. deta2 is symmetrized; a distribution whose
    covariance does not factor gets NaN."""
    with torch.enable_grad():
        e1 = mu.detach().requires_grad_(True)
        outer = e1[..., :, None] * e1[..., None, :]
        e2 = (matmul_hp(L, L.mT) + outer).detach().requires_grad_(True)
        chol, info = torch.linalg.cholesky_ex(e2 - outer)
        d1, d2 = torch.autograd.grad(chol, (e1, e2), grad_outputs=torch.tril(gL))
    bad = (info != 0)[..., None, None]
    deta2 = torch.where(bad, float("nan"), 0.5 * (d2 + d2.mT))
    return gmu + d1, deta2


def _natgrad_full(mu, L, gmu, gL, gamma):
    """Natural-gradient steps for a stack of fullrank Gaussians.

    mu: [N, m], L: [N, m, m] lower factors (Sigma = L L^T), gmu / gL the
    ordinary (ascent) gradients; gamma a scalar or one per distribution,
    [N]. Returns
    (mu_new, L_new, ok, first_ok, rescued), the last three [N] booleans:
    ``ok`` some attempt of the ladder succeeded, ``first_ok`` the first
    did, ``rescued`` a smaller gamma succeeded where the first failed. A
    distribution with ``ok`` false comes back unchanged."""
    N, m = mu.shape
    deta1, deta2 = _eta_vjp(mu, L, gmu, gL)
    Linv = _inverse_factor(L)
    P = matmul_hp(Linv.mT, Linv)  # Sigma^-1
    if not isinstance(gamma, torch.Tensor):  # filled on the device: no copy a step
        gamma = torch.full((), float(gamma), dtype=mu.dtype, device=mu.device)
    g = torch.stack([gamma.reshape(-1) * f for f in _LADDER])  # [3, N] or [3, 1]
    t1 = matmul_hp(P, mu[..., None])[..., 0] + g[..., None] * deta1  # [3, N, m]
    Pn = P - 2.0 * g[..., None, None] * deta2  # -2 theta2, [3, N, m, m]
    eye = torch.eye(m, dtype=mu.dtype, device=mu.device)
    eps = 1e-6 * torch.diagonal(Pn, dim1=-2, dim2=-1).sum(-1) / m  # f32 jitter
    Lp = linalg._cholesky_dispatch((Pn + eps[..., None, None] * eye).reshape(-1, m, m))
    Lpinv = _inverse_factor(Lp)  # NaN iff theta2 left the cone
    Sigma_new = matmul_hp(Lpinv.mT, Lpinv)
    mu_new = matmul_hp(Sigma_new, t1.reshape(-1, m, 1))[..., 0]
    L_new = linalg._cholesky_dispatch(Sigma_new)
    mu_new = mu_new.reshape(len(_LADDER), N, m)
    L_new = L_new.reshape(len(_LADDER), N, m, m)
    good = torch.isfinite(mu_new).all(-1) & torch.isfinite(L_new).flatten(-2).all(-1)
    # the first attempt that succeeded, else the old value
    mu_out, L_out = mu, L
    for a in reversed(range(len(_LADDER))):
        mu_out = torch.where(good[a][:, None], mu_new[a], mu_out)
        L_out = torch.where(good[a][:, None, None], L_new[a], L_out)
    ok = good.any(0)
    return mu_out, L_out, ok, good[0], ok & ~good[0]


def _natgrad_diag(mu, s, gmu, gs, gamma):
    """Elementwise natural-gradient step for diagonal Gaussians with log-std
    parameterization s (Sigma = diag(exp(2 s))), with the same ladder per
    coordinate. Returns (mu_new, s_new, first_ok, rescued), the flags
    reduced over every coordinate."""
    var = torch.exp(2.0 * s)
    deta1 = gmu - gs * mu / var
    deta2 = gs / (2.0 * var)
    mu_new, s_new = mu, s
    done = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    first_ok = None
    for f in _LADDER:
        g = gamma * f
        t2 = -0.5 / var + g * deta2
        var_g = -0.5 / t2
        mu_g = (mu / var + g * deta1) * var_g
        s_g = 0.5 * torch.log(var_g)
        ok = (t2 < 0) & torch.isfinite(mu_g) & torch.isfinite(s_g)
        if first_ok is None:
            first_ok = ok
        take = ok & ~done
        mu_new = torch.where(take, mu_g, mu_new)
        s_new = torch.where(take, s_g, s_new)
        done = done | ok
    return mu_new, s_new, first_ok.all(), (done & ~first_ok).any()


def _discover_pairs(model, params):
    """(mu_path, sqrt_path, q_shape, size) for every Variational node whose
    q_mu and q_sqrt both appear in `params`."""
    pairs = []

    def walk(node):
        if isinstance(node, Variational):
            base = node.path_to(model)
            mu_p, sq_p = base + ".q_mu", base + ".q_sqrt"
            if mu_p in params and sq_p in params:
                pairs.append((mu_p, sq_p, node.q_shape, node.size))
        for child in getattr(node, "sorted_variables", []):
            walk(child)

    walk(model)
    return pairs


class NaturalGradient:
    """The optimizer :func:`natural_gradient` builds: the interface of a
    ``torch.optim.Optimizer`` that the training loop uses (``zero_grad``,
    ``step``, ``state_dict``, ``load_state_dict``) over a path-keyed dict
    of trainable tensors.

    ``step`` reads each tensor's ``.grad``, the gradient of the minimized
    -objective, and flips it back to ascent for the natural step.
    ``state["gamma_scale"]`` holds each pair's adaptive scale, a device
    scalar (``adaptive=True`` only)."""

    def __init__(self, model, params, gamma, rest, adaptive):
        self.params = dict(params)
        self.gamma = gamma
        self.adaptive = bool(adaptive)
        self.pairs = tuple(_discover_pairs(model, self.params))
        pair_keys = {k for p in self.pairs for k in p[:2]}
        rest_params = [v for k, v in self.params.items() if k not in pair_keys]
        self.rest = rest(rest_params) if rest_params else None
        self.state = {}
        if self.adaptive:
            self.state["gamma_scale"] = {
                mu_p: torch.ones((), dtype=torch.float32, device=self.params[mu_p].device)
                for mu_p, *_ in self.pairs
            }

    def zero_grad(self, set_to_none=True):
        for p in self.params.values():
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _ascent(self, key):
        p = self.params[key]
        return torch.zeros_like(p) if p.grad is None else -p.grad

    @torch.no_grad()
    def step(self):
        full = []
        for mu_p, sq_p, q_shape, size in self.pairs:
            mu, q = self.params[mu_p], self.params[sq_p]
            gmu, gq = self._ascent(mu_p), self._ascent(sq_p)
            gamma = self.gamma
            if self.adaptive:
                gamma = gamma * self.state["gamma_scale"][mu_p]
            if q_shape == "diagonal":
                mu_n, q_n, first_ok, rescued = _natgrad_diag(mu, q, gmu, gq, gamma)
                mu.copy_(mu_n)
                q.copy_(q_n)
                self._adapt(mu_p, first_ok, rescued)
            elif q_shape in ("fullrank", "fullrank_packed"):
                full.append((mu_p, sq_p, q_shape, size, gamma, gmu, gq))
            else:  # Variational.__init__ admits only the three families
                raise NotImplementedError(
                    "natural_gradient has no update rule for q_shape=%r" % (q_shape,)
                )
        if full:
            self._step_full(full)
        if self.rest is not None:
            self.rest.step()

    def _step_full(self, full):
        """All fullrank pairs of the step as one [N, m, m] stack per size m
        (a fleet's [M, ...] leaves flatten into it too)."""
        by_size = {}
        for item in full:
            by_size.setdefault(item[3], []).append(item)
        for size, items in by_size.items():
            mus, Ls, gmus, gLs, gammas, counts = [], [], [], [], [], []
            for mu_p, sq_p, q_shape, _, gamma, gmu, gq in items:
                q = self.params[sq_p]
                if q_shape == "fullrank":
                    L, gL = torch.tril(q), gq
                else:
                    L, gL = fill_triangular(q, size), fill_triangular(gq, size)
                mus.append(self.params[mu_p].reshape(-1, size))
                Ls.append(L.reshape(-1, size, size))
                gmus.append(gmu.reshape(-1, size))
                gLs.append(gL.reshape(-1, size, size))
                counts.append(mus[-1].shape[0])
                if isinstance(gamma, torch.Tensor):  # the adaptive scale's
                    gammas.append(gamma.to(mus[-1].dtype).expand(counts[-1]))
                else:
                    gammas.append(torch.full((counts[-1],), float(gamma), dtype=mus[-1].dtype,
                                             device=mus[-1].device))
            mu_n, L_n, ok, first_ok, rescued = _natgrad_full(
                torch.cat(mus), torch.cat(Ls), torch.cat(gmus), torch.cat(gLs),
                torch.cat(gammas),
            )
            start = 0
            for (mu_p, sq_p, q_shape, _, _, _, _), c in zip(items, counts):
                sl = slice(start, start + c)
                start += c
                mu, q = self.params[mu_p], self.params[sq_p]
                mu.copy_(mu_n[sl].reshape(mu.shape))
                if q_shape == "fullrank":
                    q.copy_(L_n[sl].reshape(q.shape))
                else:
                    q.copy_(fill_triangular_inverse(L_n[sl]).reshape(q.shape))
                self._adapt(mu_p, first_ok[sl].all(), rescued[sl].any())

    def _adapt(self, mu_p, first_ok, rescued):
        """Shrink the pair's scale 8x on a rescued step (a smaller gamma
        succeeded: the step length was the problem), recover 2x on a clean
        first attempt, hold when the whole ladder failed (a float32
        conditioning failure no gamma fixes)."""
        if not self.adaptive:
            return
        scale = self.state["gamma_scale"][mu_p]
        scale.copy_(torch.where(
            rescued,
            torch.clamp(scale / 8.0, min=1e-6),
            torch.where(first_ok, torch.clamp(scale * 2.0, max=1.0), scale),
        ))

    def state_dict(self):
        return {
            "rest": None if self.rest is None else self.rest.state_dict(),
            "gamma_scale": dict(self.state.get("gamma_scale", {})),
        }

    def load_state_dict(self, state):
        if self.rest is not None:
            self.rest.load_state_dict(state["rest"])
        for k, v in state["gamma_scale"].items():
            self.state["gamma_scale"][k].copy_(v)


def natural_gradient(model, gamma=0.1, rest=None, adaptive=False):
    """An optimizer factory for ``Optimizer.compile``: natural-gradient
    steps on every trainable Variational (q_mu, q_sqrt) pair of `model`,
    `rest` (an optimizer factory, default ``adam(1e-2)``) on everything
    else. For a ``BatchedOptimizer`` pass any one model of the fleet: the
    pairs are found by their paths, which the fleet shares.

    adaptive=True makes the ladder a persistent per-node step-size
    controller for stochastic (Monte Carlo) objectives: each pair carries
    a scale in (0, 1] on gamma, shrunk 8x when a step is rescued by a
    smaller gamma, recovered 2x on a clean first attempt, held when the
    whole ladder fails. Do not use it on deterministic conjugate
    objectives: there the fixed unit step is exact, and any shrink moves
    into the band of gammas that stall.
    """
    rest = rest if rest is not None else adam(1e-2)

    def make(params):
        return NaturalGradient(model, params, gamma, rest, adaptive)

    make.henbun_natgrad = True
    return make
