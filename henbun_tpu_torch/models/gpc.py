"""Binary GP classification by the Laplace approximation or expectation
propagation.

The Bernoulli-sigmoid likelihood is log-concave, so the whitened Newton
mode (``inference/laplace.py``) is the posterior mode, the evidence trains
the hyperparameters with no variational parameters at all, and prediction
is deterministic: latent marginals from the mode curvature, then the
predictive probability by Gauss-Hermite quadrature of the sigmoid. The EP
counterparts (``log_marginal_ep`` / ``predict_p_ep``, ``inference/ep.py``)
match moments instead of curvature, at the cost of ~30 damped parallel
sweeps instead of ~15 Newton iterations.

Two scales share this module:

* ``GPC``: the exact-gram, full-batch classifier (O(n^3) factorizations).
  A ``BatchedOptimizer`` fleet runs its Newton forward through the CUDA
  kernel K3 (``ops/cuda_newton.py``) and its EP sweeps' factorizations and
  solves through K1 and K2.
* ``SparseGPC``: the inducing-point classifier, the same deterministic
  evidence and predictive pipeline at n >= 1e5 with every factorization
  m x m. With z = X it is GPC.
* ``SparseGPMulticlass``: the K-class (softmax) inducing-point classifier
  on the multiclass Laplace engine (``multiclass_laplace_projected``).

Labels y are {0, 1} floats of shape [n, 1] (the binary families) or
integer class indices of shape [n, 1] (``SparseGPMulticlass``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms
from ..core.param import Data, MinibatchData, Variable
from ..model import Model, AutoOptimize
from ..ops.linalg import matmul_hp
from ..parallel.rows import row_sharded


class GPC(Model):
    """Laplace GP binary classifier: p(y=1 | x) = sigmoid(f(x)),
    f ~ GP(0, k_var * k(x, x'))."""

    def setUp(self, X, Y, kern=None):
        self.X = Data(X)
        self.Y = Data(Y)
        self.kern = kern if kern is not None else gp.kernels.UnitRBF()
        self.k_var = Variable(shape=[1], transform=transforms.positive)

    def _loglik(self):
        Y = self.Y
        return lambda f: densities.bernoulli_logit(Y, f)

    def _fused(self):
        """Closed-form spec for the fused batched Newton kernel (K3)."""
        return ("bernoulli_logit", {"y": self.Y})

    def _Lk(self):
        return self.kern.Cholesky(self.X) * torch.sqrt(self.k_var)

    @AutoOptimize()
    def log_marginal_laplace(self):
        """Laplace evidence: deterministic, trains the kernel
        hyperparameters (gradients by the implicit function theorem at the
        mode)."""
        return self.laplace().log_marginal

    def laplace(self):
        """Full :class:`~henbun_tpu_torch.inference.laplace.LaplaceResult`
        at the current hyperparameters (evaluate with
        ``m.run(lambda mm: mm.laplace())``)."""
        from ..inference.laplace import laplace_whitened

        return laplace_whitened(self._loglik(), self._Lk(), fused=self._fused())

    def predict_p(self, x_new, deg=20):
        """Posterior predictive p(y=1 | x_new) [n*, 1], deterministic:
        latent Laplace marginals, then E[sigmoid(f*)] by `deg`-point
        Gauss-Hermite quadrature."""
        from ..inference.laplace import laplace_latent_marginals, laplace_whitened
        from ..ops.quadrature import gauss_hermite_expectation

        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        loglik = self._loglik()
        Lk = self._Lk()
        res = laplace_whitened(loglik, Lk, fused=self._fused())
        Ks = self.kern.K(self.X, x_new) * self.k_var
        kdiag = self.kern.Kdiag(x_new) * self.k_var[0]
        mean, var = laplace_latent_marginals(loglik, Lk, res, Ks, kdiag)
        p = gauss_hermite_expectation(torch.sigmoid, mean[:, 0], var[:, 0], deg=deg)
        return p[:, None]

    # --- expectation propagation (inference/ep.py) ------------------------
    def _K(self):
        """Scaled gram: EP's stable forms want K itself, not its factor."""
        Lk = self.kern.Cholesky(self.X)  # reuse the jittered construction
        return matmul_hp(Lk, Lk.mT) * self.k_var

    @AutoOptimize()
    def log_marginal_ep(self):
        """EP evidence: deterministic like the Laplace one, usually a
        tighter approximation for classification (GPML ch. 3.6)."""
        from ..inference.ep import ep_gp

        return ep_gp(self._loglik(), self._K()).log_marginal

    def ep(self, sweeps=30, damping=0.5):
        """Full :class:`~henbun_tpu_torch.inference.ep.EPResult` at the
        current hyperparameters (evaluate with ``m.run(lambda mm: mm.ep())``)."""
        from ..inference.ep import ep_gp

        return ep_gp(self._loglik(), self._K(), sweeps=sweeps, damping=damping)

    def predict_p_ep(self, x_new, deg=20):
        """Posterior predictive p(y=1 | x_new) [n*, 1] under the EP
        posterior, the accuracy reference for binary GP classification."""
        from ..inference.ep import ep_gp, ep_latent_marginals
        from ..ops.quadrature import gauss_hermite_expectation

        x_new = torch.as_tensor(x_new, dtype=self.X.dtype, device=self.X.device)
        K = self._K()
        res = ep_gp(self._loglik(), K)
        Ks = self.kern.K(self.X, x_new) * self.k_var
        kdiag = self.kern.Kdiag(x_new) * self.k_var[0]
        mean, var = ep_latent_marginals(res, K, Ks, kdiag)
        p = gauss_hermite_expectation(torch.sigmoid, mean[:, 0], var[:, 0], deg=deg)
        return p[:, None]


def _quantile_z(X, num_inducing, z_init):
    """The initial inducing layout: `z_init` as given, else the quantiles
    of the inputs."""
    if z_init is not None:
        return np.asarray(z_init, np.float32)
    return np.quantile(
        np.asarray(X), np.linspace(0.0, 1.0, int(num_inducing)), axis=0
    ).astype(np.float32)


def _sparse_setup(model, X, Y, num_inducing, kern, newton_iters, train_z,
                  z_penalty, z_init):
    """The shared setUp of the sparse evidence families: minibatch data, the
    quantile-initialized z (frozen in the ``inducing_z`` collection unless
    ``train_z``, then trained in a free space rescaled by 5 d0 under the
    collision barrier) and k_var."""
    from ._zguard import setup_z_guard

    model.x = MinibatchData(X)
    model.y = MinibatchData(Y)
    model.n_data = X.shape[0]
    model._newton_iters = int(newton_iters)
    # z is frozen by default: evidence training drives neighbouring
    # inducing points into collision (a coincident z is a rank-deficient
    # Kmm whose float32 Cholesky gradient blows past any jitter rescue), and
    # a collision adds no capacity. train_z=True re-enables it under the
    # gp.gp.z_repulsion barrier (inactive above half the initial min
    # spacing, infinite at coincidence)
    z = _quantile_z(X, num_inducing, z_init)
    setup_z_guard(model, z, train_z, z_penalty, model.n_data)
    model.gp = gp.SparseGP(
        kern if kern is not None else gp.kernels.UnitRBF(), z,
        collections=None if train_z else ["inducing_z"],
        # free-space rescale: one Adam step moves z by ~lr * 5 d0, not ~lr;
        # unscaled z random-walks across its own spacing at typical lr and
        # lives inside the collision barrier
        z_scale=5.0 * model._z_d0 if train_z else None,
    )
    model.k_var = Variable(shape=[1], transform=transforms.positive)


def _projection(model, x):
    """sqrt(k_var) (Lm^-1 K(z, x))^T: [B, m]."""
    return model.gp._effective_LT(x).mT * torch.sqrt(model.k_var)


def _new_projection(model, x_new):
    """(A* [n*, m], the residual (FITC) prior variance [n*]) at new
    inputs."""
    x_new = torch.as_tensor(x_new, dtype=model.x.dtype, device=model.x.device)
    LsT = model.gp._effective_LT(x_new)  # [m, n*]
    Astar = LsT.mT * torch.sqrt(model.k_var)
    corr = model.gp._additional_cov(x_new, LsT, "diagonal")
    corr = torch.maximum(corr, torch.zeros_like(corr)) * model.k_var[0]
    return Astar, corr


class SparseGPC(Model):
    """Inducing-point Laplace GP binary classifier: deterministic
    non-Gaussian training, evidence and prediction at large n.

    DTC projection: the likelihood sees f = A v with
    A = sqrt(k_var) (Lm^-1 K(z, x))^T [n, m] and a whitened inducing latent
    v ~ N(0, I_m); ``laplace_whitened`` takes the rectangular projection
    directly, so the Newton mode, the IFT gradients and the curvature all
    factorize m x m. Prediction restores the residual (FITC) variance the
    projection cannot express, then Gauss-Hermite integrates the sigmoid.
    A fleet with n, m <= 128 runs its Newton forward through K3.

    Train full-batch (the Newton mode is a deterministic function of all
    fed rows): a minibatch objective would be the Laplace evidence of the
    minibatch, stochastic and unscaled. The evidence objectives are
    ``row_sharded``: under a ``ShardedOptimizer`` with several data ranks
    each rank holds a block of the rows and the row sums are all-reduced
    (``parallel/rows.py``).
    """

    def setUp(self, X, Y, num_inducing=128, kern=None, newton_iters=15,
              train_z=False, z_penalty=None, z_init=None):
        _sparse_setup(self, X, Y, num_inducing, kern, newton_iters, train_z,
                      z_penalty, z_init)

    def _loglik(self):
        y = self.y
        return lambda f: densities.bernoulli_logit(y, f)

    def _fused(self):
        """Closed-form spec for the fused batched Newton kernel (K3)."""
        return ("bernoulli_logit", {"y": self.y})

    def _A(self, x):
        """The projection sqrt(k_var) (Lm^-1 K(z, x))^T: [B, m]."""
        return _projection(self, x)

    def _laplace(self, A):
        from ..inference.laplace import laplace_whitened

        return laplace_whitened(
            self._loglik(), A, newton_iters=self._newton_iters, fused=self._fused()
        )

    @AutoOptimize()
    @row_sharded
    def log_marginal_laplace(self):
        """Sparse Laplace evidence: deterministic; trains the kernel
        hyperparameters (and z under ``train_z=True``, guarded by the
        collision barrier)."""
        from ._zguard import z_guard

        return self._laplace(self._A(self.x)).log_marginal - z_guard(self)

    def laplace(self):
        """Full :class:`~henbun_tpu_torch.inference.laplace.LaplaceResult`
        at the current hyperparameters
        (``m.run(lambda mm: mm.laplace())``); ``v_mode`` is the whitened
        inducing mode [m, 1]."""
        return self._laplace(self._A(self.x))

    def predict_f_marginals(self, x_new):
        """Latent Laplace marginals (mean [n*, 1], var [n*, 1]) at new
        inputs; the variance includes the residual (FITC) term."""
        from ..inference.laplace import laplace_projected_marginals

        A = self._A(self.x)
        res = self._laplace(A)
        Astar, corr = _new_projection(self, x_new)
        return laplace_projected_marginals(self._loglik(), A, res, Astar, corr)

    def predict_p(self, x_new, deg=20):
        """Deterministic posterior predictive p(y=1 | x_new) [n*, 1]."""
        from ..ops.quadrature import gauss_hermite_expectation

        mean, var = self.predict_f_marginals(x_new)
        p = gauss_hermite_expectation(torch.sigmoid, mean[:, 0], var[:, 0], deg=deg)
        return p[:, None]

    # --- Bayesian hyperparameters -------------------------------------------
    def _hyperprior(self):
        """Weak lognormal(0, 4) log-priors on the evidence hyperparameters
        (k_var and the kernel's lengthscales when it has them): keeps a
        sampling target proper without informing it."""
        p = torch.sum(densities.lognormal(self.k_var, 0.0, 4.0))
        ls = getattr(self.gp.kern, "lengthscales", None)
        if ls is not None:
            p = p + torch.sum(densities.lognormal(ls, 0.0, 4.0))
        return p

    @AutoOptimize()
    @row_sharded
    def log_posterior(self):
        """Sparse Laplace evidence + weak hyperpriors: the target for
        Bayesian hyperparameters at inducing-point scale:
        ``inference.sample_posterior(m, "log_posterior")`` runs ChEES over
        (k_var, lengthscales), the chains' evidences batched under vmap, so
        their factorizations and solves take K1 and K2 on the card."""
        from ._zguard import z_guard

        return (self._laplace(self._A(self.x)).log_marginal - z_guard(self)
                + self._hyperprior())

    # --- expectation propagation (inference/ep.py, projected) --------------
    @AutoOptimize()
    @row_sharded
    def log_marginal_ep(self):
        """Sparse (projected) EP evidence, the moment-matching counterpart
        of ``log_marginal_laplace`` at the same O(n m^2) per sweep, under
        the same ep_delta convergence guard as the dense engine."""
        from ..inference.ep import ep_gp_projected
        from ._zguard import z_guard

        return ep_gp_projected(self._loglik(), self._A(self.x)).log_marginal - z_guard(self)

    def ep(self, sweeps=30, damping=0.5):
        """Full :class:`~henbun_tpu_torch.inference.ep.EPResult` at the
        current hyperparameters (``m.run(lambda mm: mm.ep())``)."""
        from ..inference.ep import ep_gp_projected

        return ep_gp_projected(self._loglik(), self._A(self.x), sweeps=sweeps,
                               damping=damping)

    def predict_p_ep(self, x_new, deg=20):
        """Deterministic posterior predictive p(y=1 | x_new) [n*, 1] under
        the projected EP posterior."""
        from ..inference.ep import ep_gp_projected, ep_projected_marginals
        from ..ops.quadrature import gauss_hermite_expectation

        A = self._A(self.x)
        res = ep_gp_projected(self._loglik(), A)
        Astar, corr = _new_projection(self, x_new)
        mean, var = ep_projected_marginals(res, A, Astar, corr)
        p = gauss_hermite_expectation(torch.sigmoid, mean[:, 0], var[:, 0], deg=deg)
        return p[:, None]


class SparseGPMulticlass(Model):
    """Inducing-point multiclass (softmax) Laplace classifier: deterministic
    K-class evidence training at n >= 1e5, the evidence counterpart of
    ``SVGPMulticlass.ELBO_bound``. With z = X and float64 it is the numpy
    oracle of the JAX package's ``tests/test_multiclass_oracle.py``.

    The softmax couples classes at each point (GPML ch. 3.5's block
    curvature), so this rides ``multiclass_laplace_projected``, which works
    on the curvature's square-root factor (shifted CholeskyQR2) and never
    forms I + A^T W A. Labels Y are integer class indices [n, 1]. Train
    full-batch (see SparseGPC); the evidence is ``row_sharded`` as
    SparseGPC's is."""

    def setUp(self, X, Y, num_classes, num_inducing=64, kern=None,
              newton_iters=15, train_z=False, z_penalty=None, z_init=None):
        self._K = int(num_classes)
        _sparse_setup(self, X, np.asarray(Y, np.int32), num_inducing, kern,
                      newton_iters, train_z, z_penalty, z_init)

    def _A(self, x):
        """The projection sqrt(k_var) (Lm^-1 K(z, x))^T: [B, m]."""
        return _projection(self, x)

    def _laplace(self, A):
        from ..inference.laplace import multiclass_laplace_projected

        return multiclass_laplace_projected(
            A, self.y[:, 0], self._K, newton_iters=self._newton_iters
        )

    @AutoOptimize()
    @row_sharded
    def log_marginal_laplace(self):
        """Multiclass Laplace evidence: deterministic; IFT gradients;
        ``row_sharded`` (see SparseGPC)."""
        from ._zguard import z_guard

        return self._laplace(self._A(self.x)).log_marginal - z_guard(self)

    def laplace(self):
        """Full :class:`~henbun_tpu_torch.inference.laplace.MulticlassLaplaceResult`
        at the current hyperparameters."""
        return self._laplace(self._A(self.x))

    def predict_p(self, x_new, num=512):
        """Deterministic posterior predictive class probabilities [n*, K]:
        joint per-point class-logit Gaussians from the blocked curvature,
        then E[softmax] by `num` fixed draws (a generator seeded 0, the
        same at every call; injection path ``"predict_p"``)."""
        from ..inference.laplace import _with_floor, multiclass_laplace_joint_marginals
        from ..ops.linalg import safe_cholesky
        from .svgp import _fixed_normal

        A = self._A(self.x)
        res = self._laplace(A)
        Astar, corr = _new_projection(self, x_new)
        means, covs = multiclass_laplace_joint_marginals(A, res, Astar, corr)
        # a scale-aware floor and safe_cholesky, not a fixed absolute
        # jitter: at large k_var the float32-rounded near-PSD covariances
        # can dip below any absolute jitter
        chols = safe_cholesky(_with_floor(covs, 1e-8), 1e-8)
        eps = _fixed_normal("predict_p", (int(num),) + tuple(means.shape), means.dtype,
                            means.device)  # [num, n*, K]
        draws = means[None] + torch.einsum("jkl,sjl->sjk", chols, eps)
        return torch.mean(torch.softmax(draws, dim=-1), dim=0)
