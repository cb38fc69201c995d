"""Bijective transforms mapping free (unconstrained) space to variable space.

Each transform provides ``forward``/``backward`` on the host (numpy),
``tf_forward`` on tensors (the name the JAX package and its reference
use), and a hand-written ``tf_log_jacobian``.
"""
from __future__ import annotations

import numpy as np
import torch

from ._settings import settings
from .ops import linalg


def _float_type():
    return settings.dtypes.float_type


def _softplus(x):
    """log(1 + exp(x)), exact for every x (no threshold switch)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Transform:
    def forward(self, x):
        """Map from the free-space to the variable space (host-side)."""
        raise NotImplementedError

    def backward(self, y):
        """Map from the variable-space to the free space (host-side)."""
        raise NotImplementedError

    def tf_forward(self, x):
        """Map from the free-space to the variable space, on tensors."""
        raise NotImplementedError

    def tf_log_jacobian(self, x):
        """log|det d tf_forward(x) / dx| as a scalar sum over elements."""
        raise NotImplementedError

    def free_state_size(self, variable_shape):
        return int(np.prod(variable_shape))

    def __str__(self):
        raise NotImplementedError


class Identity(Transform):
    def tf_forward(self, x):
        return torch.as_tensor(x)

    def forward(self, x):
        return x

    def backward(self, y):
        return y

    def tf_log_jacobian(self, x):
        return torch.zeros(1, dtype=_float_type(), device=x.device)

    def __str__(self):
        return "(none)"


class Exp(Transform):
    def __init__(self, lower=1e-6):
        self._lower = lower

    def tf_forward(self, x):
        return torch.exp(x) + self._lower

    def forward(self, x):
        return np.exp(x) + self._lower

    def backward(self, y):
        return np.log(y - self._lower)

    def tf_log_jacobian(self, x):
        return torch.sum(x)

    def __str__(self):
        return "+ve"


class Log1pe(Transform):
    """Softplus: y = log(1 + exp(x)) + lower. Alias ``positive``."""

    def __init__(self, lower=1e-6):
        self._lower = lower

    def forward(self, x):
        # overflow-safe softplus on host
        return np.logaddexp(0.0, x) + self._lower

    def tf_forward(self, x):
        return _softplus(x) + self._lower

    def tf_log_jacobian(self, x):
        # d/dx softplus = sigmoid(x); log sigmoid(x) = -softplus(-x)
        return -torch.sum(_softplus(-x))

    def backward(self, y):
        # inverse softplus, stable for large y
        ys = np.maximum(y - self._lower, 1e-12)
        return ys + np.log(-np.expm1(-ys))

    def __str__(self):
        return "+ve"


class Logistic(Transform):
    def __init__(self, a=0.0, b=1.0):
        Transform.__init__(self)
        if not b > a:
            raise ValueError("Logistic needs b > a")
        self.a, self.b = a, b

    def tf_forward(self, x):
        return self.a + (self.b - self.a) * torch.sigmoid(x)

    def forward(self, x):
        ex = np.exp(-x)
        return self.a + (self.b - self.a) / (1.0 + ex)

    def backward(self, y):
        return -np.log((self.b - self.a) / (y - self.a) - 1.0)

    def tf_log_jacobian(self, x):
        return torch.sum(x - 2.0 * _softplus(x) + np.log(self.b - self.a))

    def __str__(self):
        return "[" + str(self.a) + ", " + str(self.b) + "]"


class Scale(Transform):
    """y = a * x: a fixed linear rescaling of the free space, which gives a
    parameter an effective learning rate of lr * a under Adam."""

    def __init__(self, a):
        self.a = float(a)
        if not self.a > 0:
            raise ValueError("Scale needs a > 0")

    def forward(self, x):
        return np.asarray(x) * self.a

    def backward(self, y):
        return np.asarray(y) / self.a

    def tf_forward(self, x):
        return x * self.a

    def tf_log_jacobian(self, x):
        return torch.full(
            (1,), x.numel() * np.log(self.a), dtype=_float_type(),
            device=x.device,
        )

    def __str__(self):
        return "*%g" % self.a


class LowerTriangular(Transform):
    """Free vector of length n(n+1)/2 <-> [n, n] lower-triangular matrix,
    row-major over the triangle; volume-preserving, so the log Jacobian is
    zero."""

    def __init__(self, n):
        self.n = int(n)

    def free_state_size(self, variable_shape):
        return self.n * (self.n + 1) // 2

    def forward(self, x):
        return linalg.vec_to_tri(torch.tensor(np.asarray(x)), self.n).numpy()

    def backward(self, y):
        return linalg.tri_to_vec(torch.tensor(np.asarray(y))).numpy()

    def tf_forward(self, x):
        return linalg.vec_to_tri(x, self.n)

    def tf_log_jacobian(self, x):
        return torch.zeros(1, dtype=_float_type(), device=x.device)

    def __str__(self):
        return "LoTri->vec"


positive = Log1pe()
