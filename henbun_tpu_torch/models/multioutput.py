"""Multi-output GP regression (linear model of coregionalization).

P correlated outputs driven by Q <= P independent latent GPs through a
trainable mixing matrix A [P, Q]:

    u_q ~ GP(0, k_q),   F(x) = A u(x),   y_p ~ N(F_p(x), var_p)

The latent axis Q is a LEADING batch axis (``n_layers=[Q]`` on the
variational node): factorizations and solves batch over it and the output
mixing is one [P, Q] matmul, with no nP-sized gram. ``ELBO_mc`` is the
single-sample estimator, ``ELBO_analytic`` the closed form (Gaussian
likelihood; latents independent under q, so output variances mix by A∘A).

Devices: under ``optimizers.natural_gradient`` the layered node is Q
(q_mu, q_sqrt) pairs, stacked with the retry ladder to [3Q, n, n]: K1 and
K2 for n <= 128. With per-latent kernels, ``predict_f``'s solve is
[Q, n, n*], K2 for n, n* <= 128. A shared kernel's [n, n] factor goes to
``torch.linalg``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core.param import Data, MinibatchData, ParamList, Variable
from ..model import Model, AutoOptimize
from ..ops.linalg import matmul_hp, safe_cholesky, tri_solve
from .hetero import _q_factor
from .svgp import _layered_whitened_marginals, _quantile_z


def _q_layered_marginals(q_node, Lk):
    """Marginals of h_q = Lk_q @ u_q for a layered whitened Gaussian node
    (n_layers=[Q], shape=[n]): returns (mean [Q, n], var [Q, n]).
    Lk: [n, n] (shared kernel) or [Q, n, n] (per-latent kernels)."""
    mu = q_node.q_mu  # [Q, n]
    s = torch.reshape(q_node.scale, (-1, 1))  # [1, 1]
    LkT = Lk.mT
    mean = s * matmul_hp(mu[..., None, :], LkT)[..., 0, :]  # [Q, n]
    if q_node.q_shape == "diagonal":
        # V[h_i] = sum_j Lk_ij^2 e^{2 r_j}
        var = torch.square(s) * matmul_hp(
            torch.exp(2.0 * q_node.q_sqrt)[..., None, :], torch.square(LkT)
        )[..., 0, :]
    else:
        A = matmul_hp(Lk, _q_factor(q_node))  # [n,n] @ [Q,n,n] broadcasts
        var = torch.square(s) * torch.sum(torch.square(A), dim=-1)
    return mean, var


def _mixing_init(P, Q):
    """An identity block plus 0.1 N(0, 1) (numpy seed 0): latent q starts
    aligned with output q, breaking the rotation symmetry of the LMC
    likelihood."""
    A0 = np.zeros((P, Q), np.float32)
    A0[: min(P, Q), : min(P, Q)] = np.eye(min(P, Q), dtype=np.float32)
    return A0 + 0.1 * np.random.default_rng(0).normal(size=(P, Q)).astype(np.float32)


def _mix(mean_lat, var_lat, mix):
    """Output marginals [B, P] from latent ones [Q, B]."""
    return mean_lat.mT @ mix.mT, var_lat.mT @ torch.square(mix).mT


class MultiOutputGPR(Model):
    """LMC multi-output GP regression on an exact gram.

    Args:
      X: [n, d] inputs; Y: [n, P] outputs.
      Q: number of latent GPs (default P).
      q_shape: posterior family per latent ('fullrank' default).
      shared_kernel: one kernel for all latents (True, default) or an
        independent kernel per latent.

    Train ``ELBO_analytic`` with Adam, or with
    ``optimizers.natural_gradient(m, gamma=0.1..0.3, rest=...)``: unit gamma
    overshoots, since the mixing couples the latents (deterministic but not
    conjugate per latent).
    """

    def setUp(self, X, Y, Q=None, q_shape="fullrank", shared_kernel=True,
              analytic_kl=True):
        n, P = np.shape(Y)
        Q = int(Q) if Q is not None else int(P)
        self._P, self._Q = int(P), Q
        self.X = Data(X)
        self.Y = Data(Y)
        self.q = variationals.Gaussian(
            shape=[n], n_layers=[Q], q_shape=q_shape, analytic_kl=analytic_kl
        )
        self._shared = bool(shared_kernel)
        if shared_kernel:
            self.kern = gp.kernels.UnitRBF()
        else:
            self.kern = ParamList([gp.kernels.UnitRBF() for _ in range(Q)])
        self.mix = Variable(shape=[P, Q], mean=0.0, stddev=0.1)
        self.mix = _mixing_init(P, Q)
        self.var = Variable(shape=[P], transform=transforms.positive)

    def _latent_chols(self):
        """Cholesky factor(s) of the latent gram(s): [n, n] or [Q, n, n].
        The per-latent grams are factored as one [Q, n, n] batch (K1 on the
        card for n <= 128), each with ``Kern.Cholesky``'s jitter and its
        own escalation."""
        if self._shared:
            return self.kern.Cholesky(self.X)
        return safe_cholesky(torch.stack([k.K(self.X) for k in self.kern]),
                             gp.kernels.cholesky_jitter(self.X.shape[-2]))

    def _latent_K(self, x_new):
        """Cross-gram(s) K(X, x*): [n, n*] or [Q, n, n*]."""
        if self._shared:
            return self.kern.K(self.X, x_new)
        return torch.stack([k.K(self.X, x_new) for k in self.kern])

    def _latent_Kdiag(self, x_new):
        if self._shared:
            return self.kern.Kdiag(x_new)  # [n*]
        return torch.stack([k.Kdiag(x_new) for k in self.kern])  # [Q, n*]

    @AutoOptimize()
    def ELBO_mc(self):
        """Single-sample reparameterized estimator (reference style)."""
        Lk = self._latent_chols()
        u = self.q  # [Q, n] whitened sample
        f_lat = matmul_hp(u[..., None, :], Lk.mT)[..., 0, :]
        F = f_lat.mT @ self.mix.mT  # [n, P]
        ell = torch.sum(densities.gaussian(self.Y, F, self.var[None, :]))
        return ell - self.KL()

    @AutoOptimize()
    def ELBO_analytic(self):
        """Deterministic ELBO: exact Gaussian expected log-likelihood.
        Latents are independent under q, so V[F_ip] = sum_q A_pq^2 V[u_qi]."""
        Lk = self._latent_chols()
        mean_lat, var_lat = _q_layered_marginals(self.__dict__["q"], Lk)
        Fmean, Fvar = _mix(mean_lat, var_lat, self.mix)
        ell = torch.sum(densities.gaussian(self.Y, Fmean, self.var[None, :]))
        ell = ell - 0.5 * torch.sum(Fvar / self.var[None, :])
        return ell - self.KL()

    def predict_f(self, x_new):
        """Deterministic posterior marginals of the OUTPUTS at new inputs:
        (mean [n*, P], var [n*, P])."""
        q = self.__dict__["q"]
        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        Lk = self._latent_chols()
        A_s = tri_solve(Lk, self._latent_K(x_new))  # [(Q,) n, n*]
        mu = q.q_mu  # [Q, n]
        s = torch.reshape(q.scale, (-1, 1))
        mean_lat = s * matmul_hp(mu[..., None, :], A_s)[..., 0, :]  # [Q, n*]
        kdiag = self._latent_Kdiag(x_new)  # [n*] or [Q, n*]
        explained = torch.sum(torch.square(A_s), dim=-2)  # [(Q,) n*]
        if q.q_shape == "diagonal":
            qpart = matmul_hp(
                torch.exp(2.0 * q.q_sqrt)[..., None, :], torch.square(A_s)
            )[..., 0, :]
        else:
            G = matmul_hp(_q_factor(q).mT, A_s)  # [Q, n, n*]
            qpart = torch.sum(torch.square(G), dim=-2)
        var_lat = kdiag - explained + torch.square(s) * qpart
        var_lat = torch.maximum(var_lat, torch.zeros_like(var_lat))
        var_lat = torch.broadcast_to(var_lat, mean_lat.shape)  # [Q, n*]
        return _mix(mean_lat, var_lat, self.mix)

    def predict_y(self, x_new):
        """Predictive marginals of y (adds the per-output noise)."""
        mean, var = self.predict_f(x_new)
        return mean, var + self.var[None, :]

    def output_correlation(self):
        """The model-implied output correlation matrix (from A A^T)."""
        B = self.mix @ self.mix.mT  # [P, P] coregionalization matrix
        d = torch.sqrt(torch.diagonal(B))
        return B / (d[:, None] * d[None, :])


def make_multioutput_dataset(n=80, P=3, noise=(0.1, 0.2, 0.1), seed=0):
    """Three correlated outputs from two latent functions (sin, cos):
    y = U(x) @ W^T + eps, W = [[1, 0], [0.8, 0.6], [-0.9, 0.4]]."""
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 6, n).reshape(-1, 1).astype(np.float32)
    U = np.concatenate([np.sin(X), np.cos(X)], axis=1)  # [n, 2]
    W = np.array([[1.0, 0.0], [0.8, 0.6], [-0.9, 0.4]], np.float32)[:P]
    F = U @ W.T
    Y = F + rng.normal(size=F.shape).astype(np.float32) * np.asarray(noise[:P], np.float32)
    return X, Y.astype(np.float32), F.astype(np.float32)


class MultiOutputSVGP(Model):
    """LMC multi-output regression at SVGP scale: Q latent inducing-point
    GPs (one shared kernel and z) mixed to P outputs by a trainable
    A [P, Q], trained by minibatch SVI. The latent axis is a leading
    ``n_layers`` axis on one whitened node over m inducing values
    (``svgp._layered_whitened_marginals``)."""

    def setUp(self, X, Y, Q=None, num_inducing=64, q_shape="fullrank"):
        n, P = np.shape(Y)
        Q = int(Q) if Q is not None else int(P)
        self._P, self._Q = int(P), Q
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = n
        m = int(num_inducing)
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), _quantile_z(np.asarray(X), m))
        self.u = variationals.Normal(
            shape=[1, m], n_layers=[Q], q_shape=q_shape, analytic_kl=True
        )
        if q_shape == "fullrank":
            eye = np.eye(m, dtype=np.float32)
            self.u.q_sqrt = np.broadcast_to(eye, (Q, m, m)).copy()
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.mix = Variable(shape=[P, Q], mean=0.0, stddev=0.1)
        self.mix = _mixing_init(P, Q)
        self.var = Variable(shape=[P], transform=transforms.positive)

    def _latent_marginals(self, x):
        """Per-latent sparse marginals at x: ([Q, B], [Q, B])."""
        return _layered_whitened_marginals(self.gp, self.__dict__["u"], x, self.k_var)

    def _as_x(self, x_new):
        return torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)

    @AutoOptimize()
    def ELBO_analytic(self):
        """Deterministic ELBO: exact Gaussian expected log-likelihood under
        the mixed sparse marginals."""
        Fmean, Fvar = _mix(*self._latent_marginals(self.x), self.mix)  # [B, P]
        ell = torch.sum(densities.gaussian(self.y, Fmean, self.var[None, :]))
        ell = ell - 0.5 * torch.sum(Fvar / self.var[None, :])
        return (self.n_data / Fmean.shape[0]) * ell - self.KL()

    @AutoOptimize()
    def ELBO_mc(self):
        """Single-sample reparameterized estimator (reference style)."""
        u = torch.reshape(self.u, (self._Q, -1))  # [Q, m]
        f_lat = self.gp.samples(self.x, u, "diagonal") * torch.sqrt(self.k_var)  # [Q, B]
        F = f_lat.mT @ self.mix.mT  # [B, P]
        ell = torch.sum(densities.gaussian(self.y, F, self.var[None, :]))
        return (self.n_data / F.shape[0]) * ell - self.KL()

    def predict_f(self, x_new):
        """Deterministic posterior marginals of the OUTPUTS at new inputs:
        (mean [n*, P], var [n*, P])."""
        return _mix(*self._latent_marginals(self._as_x(x_new)), self.mix)

    def predict_y(self, x_new):
        """Predictive marginals of y (adds the per-output noise)."""
        mean, var = self.predict_f(x_new)
        return mean, var + self.var[None, :]

    def output_correlation(self, x=None):
        """The POSTERIOR output correlation over ``x`` (default: the
        inducing inputs): the cross-covariance of the learned output
        functions across inputs plus the within-point posterior coupling
        through A. At finite m the prior-level A A^T is not the quantity
        users mean: the whitened prior pins latent amplitudes only up to
        the variational gap."""
        x = self.gp.z if x is None else self._as_x(x)
        mean_lat, var_lat = self._latent_marginals(x)  # [Q, B]
        Fmean = mean_lat.mT @ self.mix.mT  # [B, P]
        M = Fmean - torch.mean(Fmean, dim=0, keepdim=True)
        B = matmul_hp(M.mT, M) / M.shape[0]
        # latents independent under q: cov(F_p, F_p') += sum_q A_pq A_p'q
        # mean_x(var_q)
        v = torch.mean(var_lat, dim=1)  # [Q]
        B = B + (self.mix * v[None, :]) @ self.mix.mT
        d = torch.sqrt(torch.diagonal(B))
        return B / (d[:, None] * d[None, :])
