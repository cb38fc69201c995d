"""Linear models, the tutorial workloads: y = a + b x + eps, with Normal
variational posteriors over a, b and the log-variance c
(``VariationalLinearModel``), or point estimates (``MAPLinearModel``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, variationals
from ..core.param import Data, Variable
from ..model import Model, AutoOptimize


class VariationalLinearModel(Model):
    def setUp(self, X, Y):
        self.X = Data(X)
        self.Y = Data(Y)
        self.a = variationals.Normal(shape=[1])
        self.b = variationals.Normal(shape=[1])
        self.c = variationals.Normal(shape=[1])

    def fit(self):
        """A posterior sample of the fit."""
        return self.a + self.b * self.X

    @AutoOptimize()
    def elbo(self):
        log_lik = densities.gaussian(self.Y, self.fit(), torch.exp(self.c))
        return torch.sum(log_lik) - self.KL()


class MAPLinearModel(Model):
    """Point-estimate (MAP) variant: plain Variables, log posterior = log
    likelihood (an implicit flat prior)."""

    def setUp(self, X, Y):
        self.X = Data(X)
        self.Y = Data(Y)
        self.a = Variable(shape=[1])
        self.b = Variable(shape=[1])
        self.c = Variable(shape=[1])

    @AutoOptimize()
    def logp(self):
        fit = self.a + self.b * self.X
        return torch.sum(densities.gaussian(self.Y, fit, torch.exp(self.c)))


def make_linear_dataset(n=100, a=1.0, b=2.0, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(-1, 1, n).reshape(-1, 1).astype(np.float32)
    Y = (a + b * X + rng.normal(size=(n, 1)) * noise).astype(np.float32)
    return X, Y
