"""Mixture-of-experts GP regression, the reference's second workload
(Expert_GPR.ipynb): two latent GPs with short and long lengthscales mixed
by a third sigmoid-gated GP.

Each step factors three 2-D [n, n] grams (one per latent GP), which go to
``torch.linalg`` (one model: the batched kernels take 3-D stacks), each
``safe_cholesky`` reading its retry flag back to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core.param import Data, Variable
from ..gp.gp import whitened_conditional
from ..model import Model, AutoOptimize
from ..ops.linalg import matmul_hp


class ExpertGPR(Model):
    """f = (sigmoid(f_r) * f_s + (1 - sigmoid(f_r)) * f_l) * k_var with
    f_s, f_l, f_r whitened GP samples (cf. Expert_GPR.ipynb cell 8)."""

    def setUp(self, X, Y):
        self.X = Data(X)
        self.Y = Data(Y)
        self.q_s = variationals.Gaussian(shape=list(Y.shape), q_shape="fullrank")
        self.q_l = variationals.Gaussian(shape=list(Y.shape), q_shape="fullrank")
        self.q_r = variationals.Gaussian(shape=list(Y.shape), q_shape="fullrank")
        self.kern_s = gp.kernels.UnitRBF(np.ones(1, np.float32) * 0.2)
        self.kern_l = gp.kernels.UnitRBF(np.ones(1, np.float32) * 1.0)
        self.kern_r = gp.kernels.UnitRBF(np.ones(1, np.float32) * 1.0)
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.k_var_r = Variable(shape=[1], transform=transforms.positive)
        self.var = Variable(shape=[1], transform=transforms.positive)

    def f_mixture(self):
        f_s = matmul_hp(self.kern_s.Cholesky(self.X), self.q_s)
        f_l = matmul_hp(self.kern_l.Cholesky(self.X), self.q_l)
        f_r = matmul_hp(self.kern_r.Cholesky(self.X), self.q_r) * torch.sqrt(self.k_var_r)
        fraction = torch.sigmoid(f_r)
        return (fraction * f_s + (1 - fraction) * f_l) * self.k_var

    def predict_f(self, x_new):
        """Posterior mixture samples at new inputs [n*, 1]: each latent GP
        is conditioned through its whitened representation (correction
        draws ``"gp_cond_diag#0..2"``)."""
        X = self.X
        x_new = torch.as_tensor(x_new, dtype=X.dtype, device=X.device)

        def cond(kern, q):
            u = q.mT  # [1, n]
            return whitened_conditional(kern, x_new, X, u, "diagonal").mT  # [n*, 1]

        f_s = cond(self.kern_s, self.q_s)
        f_l = cond(self.kern_l, self.q_l)
        f_r = cond(self.kern_r, self.q_r) * torch.sqrt(self.k_var_r)
        fraction = torch.sigmoid(f_r)
        return (fraction * f_s + (1 - fraction) * f_l) * self.k_var

    @AutoOptimize()
    def ELBO(self):
        f = self.f_mixture()
        return torch.sum(densities.gaussian(self.Y, f, self.var)) - self.KL()

    @AutoOptimize()
    def ELBO_single(self):
        """Plain single-GP fit used as the notebook's initial estimate
        (Expert_GPR.ipynb cells 12-14, Adam(0.01), jitter 3e-4)."""
        f_l = matmul_hp(self.kern_l.Cholesky(self.X), self.q_l) * self.k_var
        return torch.sum(densities.gaussian(self.Y, f_l, self.var)) - self.KL()


def make_expert_dataset(n=150, seed=0):
    """A signal that switches between rough and smooth regimes."""
    rng = np.random.default_rng(seed)
    X = np.linspace(-1, 1, n).reshape(-1, 1).astype(np.float32)
    rough = np.sin(14 * X) * 0.6
    smooth = 0.8 * X
    gate = 1.0 / (1.0 + np.exp(-8 * X))
    Y = (gate * rough + (1 - gate) * smooth + rng.normal(size=(n, 1)) * 0.1).astype(
        np.float32
    )
    return X, Y
