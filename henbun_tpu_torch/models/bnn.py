"""Bayesian neural network regression.

* ``VariationalBNN``: SVI with Variational weights (a mean-field q over
  every weight matrix), trained by the ELBO training loop.
* ``BNN``: a point-weight network whose ``log_posterior`` is the target
  density of the HMC/ChEES/NUTS/SMC samplers (``inference/``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, nn, variationals
from ..core.param import Data
from ..model import Model, AutoOptimize


class VariationalBNN(Model):
    """Mean-field variational BNN: every weight and bias is a Normal
    posterior."""

    def setUp(self, X, Y, hidden=32, var=0.1):
        self.x = Data(X)
        self.y = Data(Y)
        self.obs_var = var
        d_in, d_out = X.shape[1], Y.shape[1]
        self.net = nn.NeuralNet(
            [d_in, hidden, d_out],
            variable_types=variationals.Normal,
            neuron_types=nn.tanh,
            stddev=0.5,
        )

    @AutoOptimize()
    def ELBO(self):
        y_fit = self.net(self.x)
        return torch.sum(densities.gaussian(self.y, y_fit, self.obs_var)) - self.KL()


class BNN(Model):
    """Point-weight BNN with a Gaussian weight prior; ``log_posterior`` is
    the sampler target over the weights."""

    def setUp(self, X, Y, hidden=32, var=0.1, prior_var=1.0):
        self.x = Data(X)
        self.y = Data(Y)
        self.obs_var = var
        self.prior_var = prior_var
        d_in, d_out = X.shape[1], Y.shape[1]
        self.net = nn.NeuralNet(
            [d_in, hidden, d_out], neuron_types=nn.tanh, stddev=0.5
        )

    @AutoOptimize()
    def log_posterior(self):
        y_fit = self.net(self.x)
        log_lik = torch.sum(densities.gaussian(self.y, y_fit, self.obs_var))
        log_prior = sum(
            torch.sum(densities.gaussian(v.tensor(), 0.0, self.prior_var))
            for v in self.net.get_variables()
        )
        return log_lik + log_prior


def make_bnn_dataset(n=128, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(-2, 2, n).reshape(-1, 1).astype(np.float32)
    Y = (np.sin(2 * X) + rng.normal(size=(n, 1)) * 0.2).astype(np.float32)
    return X, Y
