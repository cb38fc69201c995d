"""Prior distributions over (transformed) parameters.

``Normal`` (standard), ``Gaussian``, ``LogNormal``, ``Gamma``, ``Laplace``,
``Uniform`` — each exposing ``logp(x)`` as the SUM of elementwise log
densities, with fixed (non-trainable) numpy hyperparameters. The
two-hyperparameter priors share one density-backed base.
"""
from __future__ import annotations

import numpy as np
import torch

from ._settings import np_float
from .core.param import Parameterized
from . import densities


class Prior(Parameterized):
    """Base class; subclasses implement logp (sum over elements)."""

    def logp(self, x):
        raise NotImplementedError

    def __str__(self):
        raise NotImplementedError


class Normal(Prior):
    """Standard normal N(0, 1) — the default whitened-parameter prior."""

    def logp(self, x):
        return -0.5 * torch.sum(np.log(2 * np.pi) + torch.square(x))

    def __str__(self):
        return "N(0,1)"


class _DensityPrior(Prior):
    """A prior defined by an elementwise density function and two fixed
    hyperparameter arrays (stored as numpy, broadcast against x)."""

    _density = None           # staticmethod(density(a, b, x) -> logpdf)
    _tag = "?"

    def __init__(self, a, b):
        Prior.__init__(self)
        self._a = np.atleast_1d(np.array(a, np_float()))
        self._b = np.atleast_1d(np.array(b, np_float()))

    def logp(self, x):
        return torch.sum(type(self)._density(self._a, self._b, x))

    def __str__(self):
        return "%s(%s,%s)" % (self._tag, self._a, self._b)


class Gaussian(_DensityPrior):
    """N(mu, var)."""

    _density = staticmethod(lambda mu, var, x: densities.gaussian(x, mu, var))
    _tag = "N"

    def __init__(self, mu, var):
        super().__init__(mu, var)
        self.mu, self.var = self._a, self._b


class LogNormal(_DensityPrior):
    """log-normal with parameters (mu, var) of log x."""

    _density = staticmethod(lambda mu, var, x: densities.lognormal(x, mu, var))
    _tag = "logN"

    def __init__(self, mu, var):
        super().__init__(mu, var)
        self.mu, self.var = self._a, self._b


class Gamma(_DensityPrior):
    """Gamma(shape, scale)."""

    _density = staticmethod(densities.gamma)
    _tag = "Ga"

    def __init__(self, shape, scale):
        super().__init__(shape, scale)
        self.shape, self.scale = self._a, self._b


class Laplace(_DensityPrior):
    """Laplace(mu, sigma)."""

    _density = staticmethod(densities.laplace)
    _tag = "Lap."

    def __init__(self, mu, sigma):
        super().__init__(mu, sigma)
        self.mu, self.sigma = self._a, self._b


class Uniform(Prior):
    """Uniform on [lower, upper]: logp = -size(x) * log(upper - lower)."""

    def __init__(self, lower=0, upper=1):
        Prior.__init__(self)
        self.lower, self.upper = lower, upper
        self.log_height = -np.log(upper - lower)

    def logp(self, x):
        return torch.full(
            (), self.log_height * x.numel(), dtype=x.dtype, device=x.device
        )

    def __str__(self):
        return "U(%s,%s)" % (self.lower, self.upper)
