"""Sparse variational GP families at scale (SVGP): minibatch SVI over N
data points with m inducing points.

    u ~ N(0, I) whitened inducing values, q(u) = Normal(q_mu, q_sqrt)
    f_i = [Lm^-1 K(z, x_i)]^T u (+ diagonal correction noise) * sqrt(k_var)
    ELBO = N/|B| sum_{i in B} log p(y_i | f_i) - KL(q(u) || N(0, I))

Regression (Gaussian, Student-t by quadrature), binary classification,
counts (Poisson) and K-class classification. The deterministic objectives
(``ELBO_analytic``, ``ELBO_quadrature``, ``ELBO_bound``) build on the
per-point Gaussian marginals of :func:`_whitened_marginals`; they are what
the natural gradient (``optimizers.py``) pairs with.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core import context as _ctx
from ..core.param import MinibatchData, Variable
from ..model import Model, AutoOptimize
from ..ops.linalg import fill_triangular, matmul_hp
from ..ops.quadrature import gauss_hermite_expectation


def _factor(q):
    """The q(u) factor of a fullrank or packed Variational node."""
    if q.q_shape == "fullrank_packed":
        return fill_triangular(q.q_sqrt, q.size)
    return torch.tril(q.q_sqrt)


def _whitened_marginals(gp_, q, x, k_var):
    """Per-point Gaussian marginals of f at x under the whitened inducing
    posterior q(u) = N(mu, S): returns (f_mean [B], f_var [B]).

        E[f_i] = (B^T mu)_i sqrt(k_var),  B = Lm^-1 K(z, x)
        V[f_i] = k_var [ (B^T S B)_ii + (Knn - Kmn^T Kmm^-1 Kmn)_ii ]
    """
    mu = q.q_mu
    LnT = gp_._effective_LT(x)  # [m, B]
    mean = matmul_hp(mu[None, :], LnT)[0]
    if q.q_shape == "diagonal":
        Svar = torch.exp(2.0 * q.q_sqrt)
        qvar = torch.sum(torch.square(LnT) * Svar[:, None], dim=0)
    else:
        T = matmul_hp(_factor(q).mT, LnT)
        qvar = torch.sum(torch.square(T), dim=0)
    corr = gp_._additional_cov(x, LnT, "diagonal")
    # corr cancels slightly negative in float32 at inputs that coincide
    # with inducing points; a tiny positive floor keeps sqrt(f_var) and its
    # gradient finite in the quadrature and predictive consumers
    return mean * torch.sqrt(k_var), _floor(qvar + corr) * k_var


def _floor(v):
    """max(v, 1e-12) with the JAX package's tie rule (half the gradient
    at a tie)."""
    return torch.maximum(v, torch.full_like(v, 1e-12))


def _layered_whitened_marginals(gp_, q, x, k_var):
    """Per-latent marginals for a layered whitened inducing posterior (q
    has ``n_layers=[Q]``, shape [1, m], one shared SparseGP): returns
    (mean [Q, B], var [Q, B])."""
    LnT = gp_._effective_LT(x)  # [m, B]
    mu = q.q_mu  # [Q, m]
    mean = torch.einsum("km,mb->kb", mu, LnT)
    if q.q_shape == "diagonal":
        Svar = torch.exp(2.0 * q.q_sqrt)  # [Q, m]
        qvar = torch.einsum("km,mb->kb", Svar, torch.square(LnT))
    else:
        T = torch.einsum("kmn,mb->knb", _factor(q), LnT)  # Lq^T B per latent
        qvar = torch.sum(torch.square(T), dim=1)
    corr = gp_._additional_cov(x, LnT, "diagonal")  # [B]
    kv = torch.reshape(k_var, ())
    return mean * torch.sqrt(kv), _floor(qvar + corr[None, :]) * kv


def _quantile_z(X, num_inducing):
    """Inducing locations on quantiles of the data."""
    return np.quantile(X, np.linspace(0.0, 1.0, num_inducing), axis=0).astype(np.float32)


def _fixed_normal(tag, shape, dtype, device):
    """Standard-normal draws that are the same at every call (a generator
    seeded 0), unless a caller injected noise for `tag` into the trace."""
    ctx = _ctx.current()
    if ctx is not None and tag in ctx.noise:
        return ctx.node_noise(tag, shape, dtype)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


class SVGPRegression(Model):
    def setUp(self, X, Y, num_inducing=64, q_shape="fullrank",
              analytic_kl=False):
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = X.shape[0]
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), _quantile_z(X, num_inducing))
        # whitened inducing-value posterior: one sample per evaluation,
        # shared across the minibatch
        self.u = variationals.Normal(
            shape=[1, num_inducing], q_shape=q_shape, analytic_kl=analytic_kl
        )
        if q_shape == "fullrank":
            # start q(u) at the whitened prior N(0, I): the dense default
            # init is a near-singular factor at m >= ~50, whose Sigma^-1
            # overflows float32 and fails every natural-gradient step
            self.u.q_sqrt = np.eye(num_inducing, dtype=np.float32)
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.var = Variable(shape=[1], transform=transforms.positive)

    def f(self, q_shape="diagonal"):
        """Posterior function samples at the current minibatch, [1, |B|]."""
        return self.gp.samples(self.x, self.u, q_shape) * torch.sqrt(self.k_var)

    def predict_f(self, x_new, q_shape="diagonal"):
        """Posterior samples of f at new inputs [n*, d] -> [1, n*]; use with
        Model.draws for bands."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        return self.gp.samples(x_new, self.u, q_shape) * torch.sqrt(self.k_var)

    def predict_y(self, x_new, q_shape="diagonal"):
        """Predictive samples of y at new inputs: f plus observation noise
        (injection path ``"predict_y#0"``)."""
        f = self.predict_f(x_new, q_shape)
        eps = _ctx.current().tagged_noise("predict_y", f.shape, f.dtype)
        return f + torch.sqrt(self.var) * eps

    def predict_f_marginals(self, x_new):
        """Deterministic posterior marginals (mean [n*, 1], var [n*, 1]) of
        f at new inputs, the closed form of averaging ``predict_f`` draws."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], x_new, self.k_var)
        return fmean[:, None], fvar[:, None]

    @AutoOptimize()
    def ELBO(self):
        f = self.f()[0][:, None]  # [|B|, 1]
        scale = self.n_data / f.shape[0]
        log_lik = torch.sum(densities.gaussian(self.y, f, self.var))
        return scale * log_lik - self.KL()

    @AutoOptimize()
    def ELBO_student_quadrature(self):
        """Deterministic robust-regression ELBO: the Student-t(3) likelihood
        integrated per marginal by Gauss-Hermite quadrature."""
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], self.x, self.k_var)
        y = self.y[:, 0]

        def log_lik(f):  # f: [B, deg]
            return densities.student_t(y[:, None], f, self.var, 3.0)

        ell = torch.sum(gauss_hermite_expectation(log_lik, fmean, fvar))
        return (self.n_data / fmean.shape[0]) * ell - self.KL()

    @AutoOptimize()
    def ELBO_analytic(self):
        """Closed-form expected log-likelihood (no f sampling):

            E[log N(y|f, var)] = log N(y | E[f], var) - V[f] / (2 var)

        with the marginals of :func:`_whitened_marginals`. With
        ``analytic_kl=True`` the objective is deterministic given the
        minibatch: the estimator the natural gradient wants."""
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], self.x, self.k_var)
        ell = torch.sum(
            densities.gaussian(self.y, fmean[:, None], self.var)
        ) - torch.sum(fvar) / (2.0 * self.var[0])
        return (self.n_data / fmean.shape[0]) * ell - self.KL()


class SVGPClassification(Model):
    """Binary GP classification: p(y=1 | x) = sigmoid(f(x)); labels y are
    {0, 1} floats."""

    def setUp(self, X, Y, num_inducing=32, q_shape="fullrank"):
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = X.shape[0]
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), _quantile_z(X, num_inducing))
        self.u = variationals.Normal(
            shape=[1, num_inducing], q_shape=q_shape, analytic_kl=True
        )
        if q_shape == "fullrank":
            self.u.q_sqrt = np.eye(num_inducing, dtype=np.float32)
        self.k_var = Variable(shape=[1], transform=transforms.positive)

    def logit_f(self, x, q_shape="diagonal"):
        return self.gp.samples(x, self.u, q_shape) * torch.sqrt(self.k_var)

    def predict_p(self, x_new, q_shape="diagonal"):
        """Samples of p(y=1 | x_new); average draws for the posterior
        predictive probability."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        return torch.sigmoid(self.logit_f(x_new, q_shape))

    def predict_p_mean(self, x_new, deg=20):
        """Deterministic posterior predictive p(y=1 | x_new) [n*, 1]:
        Gauss-Hermite quadrature of the sigmoid over the latent marginals."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], x_new, self.k_var)
        return gauss_hermite_expectation(torch.sigmoid, fmean, fvar, deg=deg)[:, None]

    @AutoOptimize()
    def ELBO(self):
        f = self.logit_f(self.x)[0][:, None]  # [|B|, 1]
        p = torch.clamp(torch.sigmoid(f), 1e-6, 1.0 - 1e-6)
        scale = self.n_data / f.shape[0]
        return scale * torch.sum(densities.bernoulli(p, self.y)) - self.KL()

    @AutoOptimize()
    def ELBO_quadrature(self):
        """Deterministic (given the minibatch) classification ELBO: each
        marginal f_i integrated with 20-point Gauss-Hermite quadrature,
        log p(y|f) = y f - softplus(f)."""
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], self.x, self.k_var)
        y = self.y[:, 0]

        def log_lik(f):  # f: [B, deg]
            return y[:, None] * f - torch.nn.functional.softplus(f)

        ell = torch.sum(gauss_hermite_expectation(log_lik, fmean, fvar))
        return (self.n_data / fmean.shape[0]) * ell - self.KL()


class SVGPCount(Model):
    """Count regression: y ~ Poisson(exp(f)). Under the marginals
    q(f_i) = N(m_i, v_i) the expected log-likelihood is closed form,

        E[log Poisson(y | e^f)] = y m - exp(m + v/2) - log y!,

    so ``ELBO_analytic`` is deterministic given the minibatch. Counts y are
    float arrays of non-negative integers."""

    def setUp(self, X, Y, num_inducing=32, q_shape="fullrank"):
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = X.shape[0]
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), _quantile_z(X, num_inducing))
        self.u = variationals.Normal(
            shape=[1, num_inducing], q_shape=q_shape, analytic_kl=True
        )
        if q_shape == "fullrank":
            self.u.q_sqrt = np.eye(num_inducing, dtype=np.float32)
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        # mean log-rate offset (counts are rarely centered on rate 1)
        self.f0 = Variable(shape=[1])

    def _marginals(self, x):
        fmean, fvar = _whitened_marginals(self.gp, self.__dict__["u"], x, self.k_var)
        return fmean + self.f0[0], fvar

    @AutoOptimize()
    def ELBO(self):
        """Single-sample Monte Carlo estimator."""
        f = self.gp.samples(self.x, self.u)[0][:, None] * torch.sqrt(self.k_var) + self.f0
        scale = self.n_data / f.shape[0]
        return scale * torch.sum(densities.poisson(torch.exp(f), self.y)) - self.KL()

    @AutoOptimize()
    def ELBO_analytic(self):
        """Deterministic ELBO through the lognormal mean (class docstring)."""
        fmean, fvar = self._marginals(self.x)
        y = self.y[:, 0]
        ell = torch.sum(y * fmean - torch.exp(fmean + fvar / 2.0) - torch.lgamma(y + 1.0))
        return (self.n_data / fmean.shape[0]) * ell - self.KL()

    def predict_rate(self, x_new):
        """Posterior mean and variance of the rate exp(f*) at new inputs
        (lognormal moments): mean = exp(m + v/2), var = (e^v - 1) mean^2.
        Returns (mean [n*, 1], var [n*, 1])."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        fmean, fvar = self._marginals(x_new)
        mean = torch.exp(fmean + fvar / 2.0)
        var = (torch.exp(fvar) - 1.0) * torch.square(mean)
        return mean[:, None], var[:, None]


class SVGPMulticlass(Model):
    """K-class GP classification: p(y = k | x) = softmax(F(x))_k with K
    latent GPs sharing one kernel (the latent axis is a leading
    ``n_layers`` axis). Labels Y are integer class indices [n, 1]."""

    def setUp(self, X, Y, num_classes, num_inducing=32, q_shape="fullrank"):
        K = int(num_classes)
        self._K = K
        self.x = MinibatchData(X)
        self.y = MinibatchData(np.asarray(Y, np.int32))
        self.n_data = X.shape[0]
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), _quantile_z(X, num_inducing))
        self.u = variationals.Normal(
            shape=[1, num_inducing], n_layers=[K], q_shape=q_shape, analytic_kl=True,
        )
        if q_shape == "fullrank":
            eye = np.eye(num_inducing, dtype=np.float32)
            self.u.q_sqrt = np.broadcast_to(eye, (K, num_inducing, num_inducing)).copy()
        self.k_var = Variable(shape=[1], transform=transforms.positive)

    def logits(self, x):
        """One posterior sample of the K logits at x: [B, K]."""
        u = torch.reshape(self.u, (self._K, -1))  # [K, m]
        f = self.gp.samples(x, u, "diagonal") * torch.sqrt(self.k_var)
        return f.mT  # [B, K]

    def predict_p(self, x_new):
        """Samples of the class-probability vectors [n*, K]; average draws
        (Model.draws) for the posterior predictive."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        return torch.softmax(self.logits(x_new), dim=-1)

    @AutoOptimize()
    def ELBO(self):
        f = self.logits(self.x)  # [B, K]
        logp = torch.gather(torch.log_softmax(f, dim=-1), -1, self.y.long())  # [B, 1]
        return (self.n_data / f.shape[0]) * torch.sum(logp) - self.KL()

    def _logit_marginals(self, x):
        """Per-class Gaussian marginals of the logits at x: ([K, B], [K, B])."""
        return _layered_whitened_marginals(self.gp, self.__dict__["u"], x, self.k_var)

    @AutoOptimize()
    def ELBO_bound(self):
        """Deterministic multiclass bound: Jensen on the partition function,

            E_q[log softmax(F)_y] >= m_y - log sum_c exp(m_c + v_c / 2),

        a slightly looser ELBO with zero gradient variance."""
        mean, var = self._logit_marginals(self.x)  # [K, B]
        y = self.y[:, 0].long()
        m_y = torch.gather(mean, 0, y[None, :])[0]  # [B]
        lse = torch.logsumexp(mean + var / 2.0, dim=0)  # [B]
        return (self.n_data / mean.shape[1]) * torch.sum(m_y - lse) - self.KL()

    def predict_p_mean(self, x_new, num=512):
        """Deterministic posterior predictive class probabilities [n*, K]:
        E[softmax(F)] over the per-class logit marginals from `num` draws
        that are the same at every call (injection path
        ``"predict_p_mean"``)."""
        x_new = torch.as_tensor(x_new, dtype=self.x.dtype, device=self.x.device)
        mean, var = self._logit_marginals(x_new)  # [K, B]
        eps = _fixed_normal("predict_p_mean", (num,) + tuple(mean.shape), mean.dtype,
                            mean.device)
        p = torch.softmax(mean[None] + torch.sqrt(var)[None] * eps, dim=1)
        return torch.mean(p, dim=0).mT  # [B, K]
