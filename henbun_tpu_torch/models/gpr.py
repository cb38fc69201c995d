"""GP regression — the GaussianProcess.ipynb workload: 1D GPR with a
fullrank Gaussian variational posterior over the whitened latent f, a
Gaussian or robust Student-t likelihood, and trainable kernel variance /
lengthscale / noise variance.

The port carries ``GPR`` (``setUp``, ``f_sample``, ``predict_f``,
``ELBO_gaussian``, ``ELBO_student``, ``ELBO_analytic``,
``ELBO_student_quadrature``, the Laplace evidence
``log_marginal_laplace_student`` with ``laplace_student`` and
``predict_f_laplace``, the EP evidence ``log_marginal_ep_student`` with
``predict_f_ep``), ``make_sine_dataset``, ``GPRMarginal`` (the
exact-marginal evidence, ``predict_f``) and ``SparseGPRobust`` (robust
regression by evidence at inducing-point scale).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core.param import Data, Variable
from ..model import Model, AutoOptimize
from ..ops.linalg import fill_triangular, matmul_hp, safe_cholesky, tri_solve
from ..parallel.rows import row_sharded


class GPR(Model):
    """Whitened-parameterization GP regression:
    f = chol(K(X)) @ q * sqrt(k_var),  y ~ N(f, var) or St(f, var, 3).
    """

    def setUp(self, X, Y, q_shape="fullrank", kern=None, analytic_kl=False):
        self.X = Data(X)
        self.Y = Data(Y)
        # variational posterior over the whitened latent, one per datapoint:
        # shaped like Y ([n, 1]), not like X
        self.q = variationals.Gaussian(
            shape=list(Y.shape), q_shape=q_shape, analytic_kl=analytic_kl
        )
        self.kern = kern if kern is not None else gp.kernels.UnitRBF()
        # kernel and likelihood variances, positive-constrained
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.var = Variable(shape=[1], transform=transforms.positive)

    def f_sample(self):
        """A posterior sample of the latent function at X (fresh noise each
        evaluation)."""
        return matmul_hp(self.kern.Cholesky(self.X), self.q) * torch.sqrt(self.k_var)

    def predict_f(self, x_new, q_shape="diagonal"):
        """Posterior samples of f at new inputs x_new [n*, d]; use with
        Model.draws:
        >>> bands = m.draws(lambda mm: mm.predict_f(grid), 100)
        """
        from ..gp.gp import whitened_conditional

        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        u = self.q.mT  # [1, n] whitened sample
        out = whitened_conditional(self.kern, x_new, self.X, u, q_shape)
        return out.mT * torch.sqrt(self.k_var)

    @AutoOptimize()
    def ELBO_gaussian(self):
        y_fit = self.f_sample()
        return torch.sum(densities.gaussian(self.Y, y_fit, self.var)) - self.KL()

    @AutoOptimize()
    def ELBO_student(self):
        """Robust regression variant: Student-t likelihood with 3 dof."""
        y_fit = self.f_sample()
        return torch.sum(densities.student_t(self.Y, y_fit, self.var, 3.0)) - self.KL()

    @AutoOptimize()
    def ELBO_analytic(self):
        """Closed-form expected log-likelihood (no f sampling): with the
        whitened q = scale * N(mu, S) and Lk = chol(K(X)),

            E[f] = sqrt(k_var) scale Lk mu
            V[f_i] = k_var scale^2 (Lk S Lk^T)_ii
            E[log N(y|f, var)] = log N(y | E[f], var) - V[f] / (2 var)

        With `analytic_kl=True` the whole objective is deterministic."""
        fmean, fvar = self._f_marginals()
        ell = torch.sum(densities.gaussian(self.Y, fmean, self.var)) - torch.sum(
            fvar
        ) / (2.0 * self.var[0])
        return ell - self.KL()

    @AutoOptimize()
    def ELBO_student_quadrature(self):
        """Deterministic robust-regression ELBO: the Student-t likelihood
        has no closed-form Gaussian expectation, so each marginal f_i is
        integrated by Gauss-Hermite quadrature (``ops/quadrature.py``), the
        zero-variance counterpart of ``ELBO_student``."""
        from ..ops.quadrature import gauss_hermite_expectation

        fmean, fvar = self._f_marginals()
        y = self.Y[:, 0]

        def log_lik(f):  # f: [n, deg]
            return densities.student_t(y[:, None], f, self.var, 3.0)

        ell = torch.sum(gauss_hermite_expectation(log_lik, fmean[:, 0], fvar))
        return ell - self.KL()

    def _student_loglik(self):
        return lambda f: densities.student_t(self.Y, f, self.var, 3.0)

    def _laplace_Lk(self):
        return self.kern.Cholesky(self.X) * torch.sqrt(self.k_var)

    @AutoOptimize()
    def log_marginal_laplace_student(self):
        """Laplace evidence for the robust Student-t likelihood: no
        variational posterior to fit. Optimizing it trains only the
        hyperparameters (kernel, k_var, var); the latent posterior is the
        Newton mode and curvature computed inside every step
        (``inference/laplace.py``; a fleet runs the Newton forward through
        K3). q gets no gradient, and Adam leaves it where it is."""
        return self.laplace_student().log_marginal

    def laplace_student(self):
        """Full :class:`~henbun_tpu_torch.inference.laplace.LaplaceResult`
        at the current hyperparameters: evaluate with
        ``m.run(lambda mm: mm.laplace_student())``."""
        from ..inference.laplace import laplace_whitened

        return laplace_whitened(
            self._student_loglik(), self._laplace_Lk(),
            fused=("student_t", {"y": self.Y, "var": self.var, "df": 3.0}),
        )

    def predict_f_laplace(self, x_new):
        """Laplace posterior marginals (mean [n*, 1], var [n*, 1]) of f at
        new inputs, deterministic (no draws needed):

            E[f*] = s A^T v_mode,  A = Lk^-1 K(X, x*),  s = sqrt(k_var)
            V[f*] = s^2 (Kdiag(x*) - colnorm(A)^2 + colnorm(G)^2),
            G = Lb^-1 A  (posterior-of-v part, B = Lb Lb^T from the mode)
        """
        from ..inference.laplace import laplace_latent_marginals, laplace_whitened

        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        Lk = self._laplace_Lk()
        loglik = self._student_loglik()
        res = laplace_whitened(loglik, Lk)
        Ks = self.kern.K(self.X, x_new) * self.k_var  # [n, n*]
        kdiag = self.kern.Kdiag(x_new) * self.k_var[0]  # [n*]
        return laplace_latent_marginals(loglik, Lk, res, Ks, kdiag)

    def _ep_K(self):
        Lk = self._laplace_Lk()
        return matmul_hp(Lk, Lk.mT)

    @AutoOptimize()
    def log_marginal_ep_student(self):
        """EP evidence for the robust Student-t likelihood, the
        moment-matching alternative to ``log_marginal_laplace_student``.
        Student-t is not log-concave, so sites with negative incoming
        precision are clipped flat and the sweeps use conservative damping
        (0.3); a fleet's sweeps factor and solve on K1 and K2."""
        from ..inference.ep import ep_gp

        return ep_gp(self._student_loglik(), self._ep_K(), sweeps=60, damping=0.3).log_marginal

    def predict_f_ep(self, x_new):
        """EP posterior marginals (mean [n*, 1], var [n*, 1]) of f at new
        inputs under the robust Student-t likelihood, the moment-matched
        counterpart of ``predict_f_laplace``."""
        from ..inference.ep import ep_gp, ep_latent_marginals

        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        K = self._ep_K()
        res = ep_gp(self._student_loglik(), K, sweeps=60, damping=0.3)
        Ks = self.kern.K(self.X, x_new) * self.k_var
        kdiag = self.kern.Kdiag(x_new) * self.k_var[0]
        return ep_latent_marginals(res, K, Ks, kdiag)

    def _f_marginals(self):
        """Per-point Gaussian marginals of f under q: (mean [n, 1], var [n])."""
        q = self.__dict__["q"]  # the Variational node, not a sample
        mu = q.q_mu  # [n]
        Lk = self.kern.Cholesky(self.X)  # [n, n]
        s = torch.sqrt(self.k_var) * torch.reshape(q.scale, ())
        fmean = s * matmul_hp(Lk, mu[:, None])  # [n, 1]
        if q.q_shape == "diagonal":
            # (Lk diag(e^{2r}) Lk^T)_ii = sum_j Lk_ij^2 e^{2 r_j}
            fvar = torch.square(s) * (torch.square(Lk) @ torch.exp(2.0 * q.q_sqrt))
        else:
            Lq = (
                fill_triangular(q.q_sqrt, q.size)
                if q.q_shape == "fullrank_packed"
                else torch.tril(q.q_sqrt)
            )
            A = matmul_hp(Lk, Lq)  # [n, n]
            fvar = torch.square(s) * torch.sum(torch.square(A), dim=1)
        return fmean, fvar


class GPRMarginal(Model):
    """Exact-marginal GP regression: hyperparameters only, the latent f
    integrated out analytically. Each evaluation factors one [n, n] gram:
    a single 2-D matrix, which ``safe_cholesky`` sends to torch.linalg."""

    def setUp(self, X, Y, kern=None):
        self.X = Data(X)
        self.Y = Data(Y)
        self.kern = kern if kern is not None else gp.kernels.UnitRBF()
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.var = Variable(shape=[1], transform=transforms.positive)

    @AutoOptimize()
    def log_marginal(self):
        """log N(y | 0, k_var K + var I) through the Cholesky-factor density,
        plus weak LogNormal hyperpriors."""
        K = self.k_var * self.kern.K(self.X)
        n = K.shape[0]
        S = K + self.var * torch.eye(n, dtype=K.dtype, device=K.device)
        L = safe_cholesky(S, 1e-6)
        lml = densities.multivariate_normal(self.Y, torch.zeros_like(self.Y), L)
        log_prior = (
            torch.sum(densities.lognormal(self.kern.lengthscales, 0.0, 1.0))
            + torch.sum(densities.lognormal(self.k_var, 0.0, 1.0))
            + torch.sum(densities.lognormal(self.var, -2.0, 1.0))
        )
        return lml + log_prior

    def predict_f(self, x_new):
        """Exact GP posterior at new inputs (no sampling), all kernel blocks
        scaled by k_var:

            mean = K*n (Knn + var I)^-1 y
            var  = k** - diag(K*n (Knn + var I)^-1 Kn*), floored at 0

        Returns (mean [n*, 1], variance [n*, 1]); evaluate under
        ``Model.run``."""
        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        Knn = self.k_var * self.kern.K(self.X)
        n = Knn.shape[0]
        # the default (1e-4-scale) jitter: gradients through a float32
        # Cholesky of an ill-conditioned gram need it
        L = safe_cholesky(Knn + self.var * torch.eye(n, dtype=Knn.dtype, device=Knn.device))
        Ksn = self.k_var * self.kern.K(x_new, self.X)  # [n*, n]
        A = tri_solve(L, Ksn.mT)  # [n, n*]
        alpha = tri_solve(L, self.Y)
        mean = A.mT @ alpha  # [n*, 1]
        kss = self.k_var * self.kern.Kdiag(x_new)  # [n*]
        var = torch.clamp(kss - torch.sum(torch.square(A), dim=0), min=0.0)
        return mean, var[:, None]


def make_sine_dataset(n=40, noise=0.3, seed=0):
    """The notebook's synthetic dataset: y = sin(x) + eps on [0, 6]."""
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 6, n).reshape(-1, 1).astype(np.float32)
    Y = (np.sin(X) + rng.normal(size=(n, 1)) * noise).astype(np.float32)
    return X, Y


class SparseGPRobust(Model):
    """Deterministic robust regression at inducing-point scale:
    y ~ Student-t(df)(f, var) with f a sparse GP, evidence-trained like
    ``GPR.log_marginal_laplace_student`` / ``log_marginal_ep_student`` but
    with every factorization m x m (the rectangular ``laplace_whitened``
    and ``ep_gp_projected``; the DTC projection of ``SparseGPC``).

    Student-t is not log-concave: the Laplace path relies on the
    saddle-free |W| Newton ladder, the EP path on clipped sites and
    conservative damping (0.3). Train full-batch (see SparseGPC's note on
    minibatch evidence); the evidence objectives are ``row_sharded`` as
    SparseGPC's are.
    """

    def setUp(self, X, Y, num_inducing=64, kern=None, newton_iters=15,
              df=3.0, train_z=False, z_penalty=None, z_init=None):
        from .gpc import _sparse_setup

        self._df = float(df)
        _sparse_setup(self, X, Y, num_inducing, kern, newton_iters, train_z,
                      z_penalty, z_init)
        self.var = Variable(shape=[1], transform=transforms.positive)

    def _loglik(self):
        y, var, df = self.y, self.var, self._df
        return lambda f: densities.student_t(y, f, var, df)

    def _fused(self):
        """Closed-form spec so batched calls take the fused Newton kernel
        (K3); must mirror ``_loglik``."""
        return ("student_t", {"y": self.y, "var": self.var, "df": self._df})

    def _A(self, x):
        from .gpc import _projection

        return _projection(self, x)

    def _laplace_evidence(self):
        from ..inference.laplace import laplace_whitened

        return laplace_whitened(
            self._loglik(), self._A(self.x),
            newton_iters=self._newton_iters, fused=self._fused(),
        ).log_marginal

    @AutoOptimize()
    @row_sharded
    def log_marginal_laplace(self):
        """Sparse Laplace evidence (saddle-free Newton; IFT gradients)."""
        from ._zguard import z_guard

        return self._laplace_evidence() - z_guard(self)

    @AutoOptimize()
    @row_sharded
    def log_marginal_ep(self):
        """Projected EP evidence through the unrolled sweeps
        (``implicit_diff=False``): as the noise variance sharpens, outlier
        sites thrash between explaining and rejecting their point and the
        mean site residual stays large whatever the damping or sweeps, so
        the fixed-point gradient's premise does not hold; reverse mode
        through the damped sweeps needs none. Clipped sites and damping
        0.3 as in the dense Student-t engine."""
        from ..inference.ep import ep_gp_projected
        from ._zguard import z_guard

        return ep_gp_projected(
            self._loglik(), self._A(self.x), sweeps=60, damping=0.3,
            implicit_diff=False,
        ).log_marginal - z_guard(self)

    # --- Bayesian hyperparameters -------------------------------------------
    def _hyperprior(self):
        """Weak lognormal(0, 4) log-priors on (k_var, noise var, kernel
        lengthscales): keeps a sampling target proper."""
        p = torch.sum(densities.lognormal(self.k_var, 0.0, 4.0))
        p = p + torch.sum(densities.lognormal(self.var, 0.0, 4.0))
        ls = getattr(self.gp.kern, "lengthscales", None)
        if ls is not None:
            p = p + torch.sum(densities.lognormal(ls, 0.0, 4.0))
        return p

    @AutoOptimize()
    @row_sharded
    def log_posterior(self):
        """Sparse robust (Student-t) Laplace evidence + weak hyperpriors:
        Bayesian hyperparameters for heavy-tailed regression at
        inducing-point scale (see ``SparseGPC.log_posterior``)."""
        from ._zguard import z_guard

        return self._laplace_evidence() - z_guard(self) + self._hyperprior()

    def predict_f(self, x_new):
        """Laplace posterior marginals (mean [n*, 1], var [n*, 1]) of the
        latent at new inputs, residual (FITC) variance restored. The mode
        comes from the generic Newton loop (no fused spec), as in the JAX
        package."""
        from ..inference.laplace import laplace_projected_marginals, laplace_whitened
        from .gpc import _new_projection

        loglik = self._loglik()
        A = self._A(self.x)
        res = laplace_whitened(loglik, A, newton_iters=self._newton_iters)
        Astar, corr = _new_projection(self, x_new)
        return laplace_projected_marginals(loglik, A, res, Astar, corr)

    def predict_f_ep(self, x_new):
        """EP posterior marginals at new inputs, the moment-matched
        counterpart of ``predict_f``."""
        from ..inference.ep import ep_gp_projected, ep_projected_marginals
        from .gpc import _new_projection

        A = self._A(self.x)
        res = ep_gp_projected(self._loglik(), A, sweeps=60, damping=0.3)
        Astar, corr = _new_projection(self, x_new)
        return ep_projected_marginals(res, A, Astar, corr)
