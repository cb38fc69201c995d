"""Heteroscedastic GP regression: input-dependent noise.

Two whitened latent GPs, f for the mean and g for the LOG noise variance,
with y ~ N(f(x), exp(g(x))). Under independent Gaussian marginals
q(f_i) = N(mf, vf), q(g_i) = N(mg, vg) the expected log-likelihood is
closed form,

    E[log N(y | f, e^g)] = -0.5 log 2pi - 0.5 mg
                           - 0.5 ((y - mf)^2 + vf) * exp(-mg + vg/2)

(E[e^{-g}] is the lognormal mean), so ``ELBO_analytic`` is deterministic
given the data; ``ELBO_mc`` keeps the single-sample estimator.

Devices: one model's two [n, n] gram factors go to ``torch.linalg``; a
``BatchedOptimizer`` fleet (n <= 128) stacks them to [M, n, n] under
``torch.func.vmap``, which sends each factor to K1 and each Murray
backward's two L^T solves to K2 (``ops/linalg.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core.param import Data, MinibatchData, Variable
from ..model import Model, AutoOptimize
from ..ops.linalg import fill_triangular, matmul_hp, tri_solve
from .svgp import _quantile_z, _whitened_marginals

_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))


def _q_factor(q_node):
    """The lower factor of a fullrank or packed Variational node."""
    if q_node.q_shape == "fullrank_packed":
        return fill_triangular(q_node.q_sqrt, q_node.size)
    return torch.tril(q_node.q_sqrt)


def whitened_q_marginals(q_node, Lk):
    """Marginals (mean [n, 1], var [n]) of h = Lk @ q for a whitened
    Gaussian variational node q = scale * N(mu, L L^T) (any q_shape)."""
    mu = q_node.q_mu
    s = torch.reshape(q_node.scale, ())
    mean = s * matmul_hp(Lk, mu[:, None])
    if q_node.q_shape == "diagonal":
        var = torch.square(s) * (torch.square(Lk) @ torch.exp(2.0 * q_node.q_sqrt))
    else:
        A = matmul_hp(Lk, _q_factor(q_node))
        var = torch.square(s) * torch.sum(torch.square(A), dim=1)
    return mean, var


def whitened_q_marginals_at(q_node, kern, Lk, X, x_new):
    """Posterior marginals (mean [n*, 1], var [n*]) of the latent GP at NEW
    inputs under the whitened q: with A = Lk^-1 K(X, x*),

        E[h*] = A^T (s mu)
        V[h*] = kdiag(x*) - colnorm(A)^2 + s^2 colnorm(Lq^T A)^2
    """
    A = tri_solve(Lk, kern.K(X, x_new))  # [n, n*]
    mu = q_node.q_mu
    s = torch.reshape(q_node.scale, ())
    mean = s * (A.mT @ mu[:, None])  # [n*, 1]
    kdiag = kern.Kdiag(x_new)
    explained = torch.sum(torch.square(A), dim=0)
    if q_node.q_shape == "diagonal":
        qpart = torch.square(s) * (torch.exp(2.0 * q_node.q_sqrt) @ torch.square(A))
    else:
        G = matmul_hp(_q_factor(q_node).mT, A)  # [n, n*]
        qpart = torch.square(s) * torch.sum(torch.square(G), dim=0)
    # float32 cancellation at near-training inputs can push this slightly
    # negative (the floor passes half the gradient at a tie, as jnp.maximum)
    var = kdiag - explained + qpart
    var = torch.maximum(var, torch.zeros_like(var))
    return mean, var


class HeteroscedasticGPR(Model):
    """y ~ N(f(x), exp(g(x))) with independent whitened GP posteriors over
    f and g. `g0` is the trainable mean log-noise level (so kern_g models
    the *variation* of the noise around it)."""

    def setUp(self, X, Y, q_shape="fullrank", kern_f=None, kern_g=None,
              analytic_kl=True):
        self.X = Data(X)
        self.Y = Data(Y)
        # one latent value per row ([n, 1], as Y)
        self.q_f = variationals.Gaussian(
            shape=list(Y.shape), q_shape=q_shape, analytic_kl=analytic_kl
        )
        # q_g starts tight: the objective exponentiates its marginal
        # variance, and exp(gvar/2) overflows float32 from the default
        # init at n >~ 80
        self.q_g = variationals.Gaussian(
            shape=list(Y.shape), q_shape=q_shape, analytic_kl=analytic_kl,
            stddev=0.1,
        )
        if q_shape == "fullrank":
            # the dense fullrank init puts ~stddev in EVERY entry (marginal
            # variances O(n^2/4)): start both factors near the identity
            n = int(np.prod(Y.shape))
            eye = np.eye(n, dtype=np.asarray(Y).dtype)
            for qn in (self.q_f, self.q_g):
                qn.q_sqrt.set_free_value(eye + 0.01 * np.asarray(qn.q_sqrt.free_value))
        self.kern_f = kern_f if kern_f is not None else gp.kernels.UnitRBF()
        self.kern_g = kern_g if kern_g is not None else gp.kernels.UnitRBF()
        self.k_var_f = Variable(shape=[1], transform=transforms.positive)
        self.k_var_g = Variable(shape=[1], transform=transforms.positive)
        self.g0 = Variable(shape=[1], mean=-2.0)  # mean log noise variance

    def _marginals(self):
        """Closed-form marginals of f and g under q (means [n,1], vars [n])."""
        Lkf = self.kern_f.Cholesky(self.X)
        Lkg = self.kern_g.Cholesky(self.X)
        fmean, fvar = self._scale_f(*whitened_q_marginals(self.__dict__["q_f"], Lkf))
        gmean, gvar = self._scale_g(*whitened_q_marginals(self.__dict__["q_g"], Lkg))
        return fmean, fvar, gmean, gvar

    def _scale_f(self, mean, var):
        return mean * torch.sqrt(self.k_var_f), var * self.k_var_f[0]

    def _scale_g(self, mean, var):
        """Apply g's amplitude and the mean log-noise level."""
        return mean * torch.sqrt(self.k_var_g) + self.g0, var * self.k_var_g[0]

    def _at(self, q, kern, x_new):
        """whitened_q_marginals_at for the latent `q` ("q_f" or "q_g")."""
        X = self.X
        x_new = torch.as_tensor(x_new, dtype=X.dtype, device=X.device)
        return whitened_q_marginals_at(self.__dict__[q], kern, kern.Cholesky(X), X, x_new)

    @AutoOptimize()
    def ELBO_mc(self):
        """Reference-style single-sample reparameterized estimator."""
        f = matmul_hp(self.kern_f.Cholesky(self.X), self.q_f) * torch.sqrt(self.k_var_f)
        g = (
            matmul_hp(self.kern_g.Cholesky(self.X), self.q_g) * torch.sqrt(self.k_var_g)
            + self.g0
        )
        return torch.sum(densities.gaussian(self.Y, f, torch.exp(g))) - self.KL()

    @AutoOptimize()
    def ELBO_analytic(self):
        """Deterministic ELBO: closed-form expected log-likelihood + analytic
        KLs. Pair with Adam or low-gamma natural gradients (deterministic
        but not conjugate: the exp(-g) coupling)."""
        fmean, fvar, gmean, gvar = self._marginals()
        r2 = torch.square(self.Y - fmean) + fvar[:, None]
        e_inv_noise = torch.exp(-gmean + gvar[:, None] / 2.0)
        ell = torch.sum(-_HALF_LOG_2PI - 0.5 * gmean - 0.5 * r2 * e_inv_noise)
        return ell - self.KL()

    def predict_y(self, x_new):
        """Predictive mean and variance of y at new inputs, deterministic:

            E[y*]  = E[f*]
            V[y*]  = V[f*] + E[e^{g*}] = V[f*] + exp(E[g*] + V[g*]/2)

        Returns (mean [n*, 1], var [n*, 1])."""
        fmean, fvar = self._scale_f(*self._at("q_f", self.kern_f, x_new))
        gmean, gvar = self._scale_g(*self._at("q_g", self.kern_g, x_new))
        noise = torch.exp(gmean + gvar[:, None] / 2.0)
        return fmean, fvar[:, None] + noise

    def predict_g(self, x_new):
        """Posterior marginals (mean [n*, 1], var [n*, 1]) of the log noise
        variance g at new inputs."""
        gmean, gvar = self._scale_g(*self._at("q_g", self.kern_g, x_new))
        return gmean, gvar[:, None]


def make_hetero_dataset(n=120, seed=0):
    """y = sin(x) + eps, eps ~ N(0, sd(x)^2) with sd rising from 0.05 to
    ~0.45 across [0, 6]."""
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 6, n).reshape(-1, 1).astype(np.float32)
    sd = 0.05 + 0.4 / (1.0 + np.exp(-2.0 * (X - 3.0)))
    Y = (np.sin(X) + rng.normal(size=X.shape) * sd).astype(np.float32)
    return X, Y, sd.astype(np.float32)


class HeteroSVGP(Model):
    """Heteroscedastic regression at SVGP scale: f (mean) and g (log noise
    variance) are whitened inducing-point latents sharing one z grid;
    per-minibatch-point marginals come from ``svgp._whitened_marginals``
    and plug into the same lognormal-mean identity as the exact-gram
    family. The identity q_sqrt init puts the inducing marginal variances
    at O(Kdiag) = O(1), so this family has no init cliff."""

    def setUp(self, X, Y, num_inducing=64, q_shape="fullrank"):
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = X.shape[0]
        m = int(num_inducing)
        z = _quantile_z(np.asarray(X), m)
        self.gp_f = gp.SparseGP(gp.kernels.UnitRBF(), z)
        self.gp_g = gp.SparseGP(gp.kernels.UnitRBF(), z.copy())
        self.u_f = variationals.Normal(shape=[1, m], q_shape=q_shape, analytic_kl=True)
        self.u_g = variationals.Normal(shape=[1, m], q_shape=q_shape, analytic_kl=True)
        if q_shape == "fullrank":
            eye = np.eye(m, dtype=np.float32)
            self.u_f.q_sqrt = eye.copy()
            self.u_g.q_sqrt = eye.copy()
        self.k_var_f = Variable(shape=[1], transform=transforms.positive)
        self.k_var_g = Variable(shape=[1], transform=transforms.positive)
        self.g0 = Variable(shape=[1], mean=-2.0)

    def _marginals(self, x):
        """Sparse marginals of f and g at x: (mf [B], vf [B], mg [B], vg [B])."""
        fmean, fvar = _whitened_marginals(self.gp_f, self.__dict__["u_f"], x, self.k_var_f)
        gmean, gvar = _whitened_marginals(self.gp_g, self.__dict__["u_g"], x, self.k_var_g)
        return fmean, fvar, gmean + self.g0[0], gvar

    @AutoOptimize()
    def ELBO_analytic(self):
        """Deterministic (given the minibatch) closed-form ELBO."""
        fmean, fvar, gmean, gvar = self._marginals(self.x)
        y = self.y[:, 0]
        r2 = torch.square(y - fmean) + fvar
        e_inv_noise = torch.exp(-gmean + gvar / 2.0)
        ell = torch.sum(-_HALF_LOG_2PI - 0.5 * gmean - 0.5 * r2 * e_inv_noise)
        return (self.n_data / fmean.shape[0]) * ell - self.KL()

    @AutoOptimize()
    def ELBO_mc(self):
        """Reference-style single-sample reparameterized estimator."""
        f = self.gp_f.samples(self.x, self.u_f)[0] * torch.sqrt(self.k_var_f)
        g = self.gp_g.samples(self.x, self.u_g)[0] * torch.sqrt(self.k_var_g) + self.g0
        y = self.y[:, 0]
        ell = torch.sum(densities.gaussian(y, f, torch.exp(g)))
        return (self.n_data / f.shape[0]) * ell - self.KL()

    def _as_x(self, x_new):
        return torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)

    def predict_y(self, x_new):
        """Deterministic predictive mean/variance of y at new inputs:
        E[y*] = E[f*], V[y*] = V[f*] + exp(E[g*] + V[g*]/2).
        Returns (mean [n*, 1], var [n*, 1])."""
        fmean, fvar, gmean, gvar = self._marginals(self._as_x(x_new))
        noise = torch.exp(gmean + gvar / 2.0)
        return fmean[:, None], (fvar + noise)[:, None]

    def predict_g(self, x_new):
        """Posterior marginals (mean [n*, 1], var [n*, 1]) of the log noise
        variance at new inputs."""
        _, _, gmean, gvar = self._marginals(self._as_x(x_new))
        return gmean[:, None], gvar[:, None]
