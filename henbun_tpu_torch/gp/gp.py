"""Whitened (sparse) GP posterior sampling: ``GP`` (samples =
u @ Cholesky(K(x))^T), ``SparseGP`` (inducing points z; samples =
u @ (Lm^-1 Kmn) plus an 'additional covariance' correction in
{'diagonal','neglected','fullrank'} flavors) and ``whitened_conditional``.

Correction noise comes from the trace context's tagged noise, so a caller
can inject it like any node's noise.

``z_min_spacing`` and ``z_repulsion`` size and apply the inducing-point
collision barrier of the evidence families (``models/_zguard.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import context as _ctx
from ..core.param import Variable, Parameterized, graph_key
from .._settings import settings
from ..ops.linalg import eye, matmul_hp, safe_cholesky, tri_solve


def _float_type():
    return settings.dtypes.float_type


def _safe_corr_std(diag_cov):
    """sqrt of the correction variance with a jitter floor: the raw
    sqrt(|x|) has an infinite gradient where the explained variance cancels
    diag_cov to ~0; the floor bounds it at 1/(2 sqrt(jitter)). At a row on
    an inducing point diag_cov can cancel to exactly 0: ``torch.maximum``
    passes half the gradient there, as ``jnp.maximum`` does (``clamp``
    would pass all of it)."""
    jitter = settings.numerics.jitter_level
    return torch.sqrt(torch.maximum(diag_cov, torch.zeros_like(diag_cov)) + jitter)


def whitened_conditional(kern, x_new, x, u, q_shape="diagonal"):
    """Exact GP conditional through the whitened representation.

    With f = L u (L = chol(K(x))), f* = K(x, x*)^T L^-T u +
    N(0, K** - K*^T K^-1 K*). u: [N, n]; returns [N, n*]. q_shape in
    {'neglected','diagonal','fullrank'} controls the residual-variance term.
    """
    if q_shape not in ("neglected", "diagonal", "fullrank"):
        raise ValueError("unknown q_shape %r" % (q_shape,))
    ctx = _ctx.current()
    Lm = kern.Cholesky(x)  # [n, n]
    LnT = tri_solve(Lm, kern.K(x, x_new))  # [n, n*]
    samples = matmul_hp(u, LnT)  # [N, n] @ [n, n*] -> [N, n*]
    if q_shape == "neglected":
        return samples
    if q_shape == "diagonal":
        diag_cov = kern.Kdiag(x_new) - torch.sum(torch.square(LnT), -2)
        noise = ctx.tagged_noise("gp_cond_diag", samples.shape, _float_type())
        return samples + _safe_corr_std(diag_cov) * noise
    cov = kern.K(x_new) - matmul_hp(LnT.mT, LnT)
    chol = safe_cholesky(cov, settings.numerics.jitter_level)
    noise = ctx.tagged_noise("gp_cond_full", samples.shape, _float_type())
    return samples + matmul_hp(noise, chol.mT)


class GP(Parameterized):
    """Sample from the whitened GP posterior: mean L*u.q_mu, covariance
    (L*u.q_sqrt)(L*u.q_sqrt)^T, with L = chol(K(x,x))."""

    def __init__(self, kern):
        Parameterized.__init__(self)
        self.kern = kern

    def samples(self, x, u):
        """x: [n, d] coordinates; u: whitened variational sample [N, n].
        Returns posterior samples sized [N, n]."""
        L = self.kern.Cholesky(x)  # [n, n]
        return matmul_hp(u, L.mT)

    def conditional_samples(self, x_new, x, u, q_shape="diagonal"):
        """Posterior samples at NEW points x_new [n*, d], conditioned through
        the whitened representation at the points x [n, d]. See
        :func:`whitened_conditional`."""
        return whitened_conditional(self.kern, x_new, x, u, q_shape)


class SparseGP(GP):
    """Sparse (inducing-point) approximation of the GP posterior:
    N(Knm Lm^-T q_mu, (Knn - Knm Kmm^-1 Kmn) + (Knm Lm^-T q_sqrt)^2)."""

    def __init__(self, kern, z, collections=None, z_scale=None):
        """z: [m, d] np.array of initial inducing point locations.

        z_scale: optional free-space rescaling (`transforms.Scale`) so a
        trainable z moves ~lr * z_scale per Adam step instead of ~lr."""
        GP.__init__(self, kern)
        collections = collections if collections is not None else [graph_key.VARIABLES]
        from ..transforms import Scale

        self.z = Variable(
            shape=z.shape,
            collections=collections,
            transform=None if z_scale is None else Scale(z_scale),
        )
        self.z = z  # deferred assign of the initial value
        self.m = len(z)

    def samples(self, x, u, q_shape="diagonal"):
        """x: [n, d] or batched [N, n, d]; u: whitened inducing values [N, m].
        q_shape: how to treat Knn - Knm Kmm^-1 Kmn
        ('diagonal' default / 'neglected' / 'fullrank')."""
        if q_shape not in ("diagonal", "neglected", "fullrank"):
            raise ValueError("unknown q_shape %r" % (q_shape,))
        jitter = settings.numerics.jitter_level
        N = u.shape[0]
        ctx = _ctx.current()

        LnT = self._effective_LT(x)  # [m, n] or [N, m, n]
        if x.ndim == 2:
            samples = matmul_hp(u, LnT)  # [N, m] @ [m, n] -> [N, n]
        elif x.ndim == 3:
            # [N, 1, m] @ [N, m, n] -> [N, n]
            samples = matmul_hp(u[:, None, :], LnT).squeeze(-2)
        else:
            raise ValueError("x must be [n, d] or [N, n, d]")

        if q_shape == "neglected":
            return samples
        if q_shape == "diagonal":
            diag_cov = self._additional_cov(x, LnT, "diagonal")
            noise = ctx.tagged_noise("sparse_gp_diag", x.shape[:-1], _float_type())
            return samples + _safe_corr_std(diag_cov) * noise
        jitterI = eye(x.shape[-2], device=x.device) * jitter
        cov = self._additional_cov(x, LnT, "fullrank") + jitterI
        L, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where((info != 0)[..., None, None], float("nan"), L)
        if x.ndim == 2:
            noise = ctx.tagged_noise("sparse_gp_full", (N, x.shape[0]), _float_type())
            return samples + matmul_hp(noise, chol.mT)
        # batched: [N, 1, n] @ [N, n, n]^T -> [N, n]
        noise = ctx.tagged_noise("sparse_gp_full", (N, 1, x.shape[1]), _float_type())
        return matmul_hp(noise, chol.mT).squeeze(-2) + samples

    def _effective_LT(self, x):
        """Lm^-1 Kmn with Lm Lm^T = Kmm.
        x: [n, d] -> [m, n]; x: [N, n, d] -> [N, m, n]."""
        Lm = self.kern.Cholesky(self.z)  # [m, m]
        if x.ndim == 2:
            return tri_solve(Lm, self.kern.K(self.z, x))
        if x.ndim == 3:
            Lminv = tri_solve(Lm, eye(self.m, device=Lm.device))
            # broadcast z against the batch axis: [1,m,d] vs [N,n,d] -> [N,m,n]
            Kmn = self.kern.K(self.z[None, :, :], x)
            return matmul_hp(Lminv[None, :, :], Kmn)
        raise ValueError("shape is not specified for tensor x")

    def _additional_cov(self, x, LnT, q_shape):
        """Knn - Knm Kmm^-1 Kmn, diagonal or full."""
        if q_shape == "diagonal":
            return self.kern.Kdiag(x) - torch.sum(torch.square(LnT), -2)
        Knn = self.kern.K(x)
        return Knn - matmul_hp(LnT.mT, LnT)


def z_min_spacing(z):
    """Smallest positive pairwise Euclidean distance among inducing points
    (host-side numpy; used at setUp time to size the repulsion barrier).
    Returns 0.0 if every pair coincides."""
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    z = np.asarray(z, np.float64)
    d2 = np.sum((z[:, None, :] - z[None, :, :]) ** 2, axis=-1)
    iu = np.triu_indices(len(z), k=1)
    vals = d2[iu]
    pos = vals[vals > 0]
    return float(np.sqrt(pos.min())) if pos.size else 0.0


def z_repulsion(z, d0, weight):
    """Inducing-point collision barrier: exactly zero while every pairwise
    distance exceeds d0, growing like weight * (d0/d - 1)^2 -> infinity as
    a pair approaches coincidence.

    Evidence training of z drives neighbouring inducing points into
    collision (a coincident z makes Kmm rank-deficient past any jitter
    rescue). A colliding pair adds no capacity, so an inverse-square hinge
    costs nothing when inactive and halts any finite attraction at a
    spacing O(d0). C^1 at the hinge; subtract from the evidence objective.

    z: [m, d]; d0: barrier onset distance (a float, typically half the
    initial min spacing); weight: barrier scale (typically n_data: evidence
    gradients are O(n))."""
    m = z.shape[-2]
    d2 = torch.sum(torch.square(z[..., :, None, :] - z[..., None, :, :]), dim=-1)
    # self-pairs: pushed beyond the hinge so they contribute exactly zero
    d2 = d2 + torch.eye(m, dtype=z.dtype, device=z.device) * (4.0 * d0 * d0)
    # the floor keeps the sqrt gradient finite at an exactly coincident
    # pair (the barrier there is ~weight/floor: effectively infinite)
    r = torch.sqrt(d2 / (d0 * d0) + 1e-12)
    pen = torch.square(torch.relu(1.0 / r - 1.0))
    return 0.5 * weight * torch.sum(pen)  # each pair appears twice
