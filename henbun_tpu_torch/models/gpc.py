"""Binary GP classification by the Laplace approximation.

The Bernoulli-sigmoid likelihood is log-concave, so the whitened Newton
mode (``inference/laplace.py``) is the posterior mode, the evidence trains
the hyperparameters with no variational parameters at all, and prediction
is deterministic: latent marginals from the mode curvature, then the
predictive probability by Gauss-Hermite quadrature of the sigmoid. A
``BatchedOptimizer`` fleet of GPCs runs its Newton forward through the CUDA
kernel K3 (``ops/cuda_newton.py``).

The port carries ``GPC`` with ``setUp``, the Laplace evidence,
``laplace`` and ``predict_p``; the EP methods and ``SparseGPC`` come with
their own slices.

Labels y are {0, 1} floats of shape [n, 1].
"""
from __future__ import annotations

import torch

from .. import densities, gp, transforms
from ..core.param import Data, Variable
from ..model import Model, AutoOptimize


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
