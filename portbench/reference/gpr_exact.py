"""float64 reference of ``gpr_exact``: ``GPRMarginal``'s exact evidence
with its LogNormal hyperpriors, and its ``predict_f``, from the equations:

    S = k_var K(X) + var I,  L = chol(S + 1e-6 I)
    evidence = log N(y | 0, L L^T) + log LN(l; 0, 1) + log LN(k_var; 0, 1)
               + log LN(var; -2, 1)

    predict:  L = chol(k_var K(X) + var I + 1e-4 I),  A = L^-1 K(X, x*) k_var
              mean = A^T L^-1 y,  var = max(k_var - colsum(A^2), 0)
"""
from __future__ import annotations

import math

import torch

from .common import positive, rbf

EVIDENCE_JITTER = 1e-6  # GPRMarginal.log_marginal's safe_cholesky(S, 1e-6)
PREDICT_JITTER = 1e-4  # predict_f's safe_cholesky at [numerics] jitter_level


def _lognormal(x, mu, var):
    lx = torch.log(x)
    return -0.5 * math.log(2 * math.pi * var) - 0.5 * torch.square(lx - mu) / var - lx


def _hypers(params):
    return (positive(params["kern.lengthscales"]), positive(params["k_var"]),
            positive(params["var"]))


def objective(params, data, noise=None, matmul=torch.matmul):
    """The evidence plus hyperpriors: params {path: [1]} free values, data
    {"X", "Y": [n, 1]}, float64. It has no product for `matmul` to
    change: the control of this configuration is the program's own TF32."""
    X, Y = data["X"], data["Y"]
    n = X.shape[0]
    ls, k_var, var = _hypers(params)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(k_var * rbf(X, X, ls) + (var + EVIDENCE_JITTER) * eye)
    del eye
    alpha = torch.linalg.solve_triangular(L, Y, upper=False)
    lml = (-0.5 * n * math.log(2 * math.pi) - torch.sum(torch.log(torch.diagonal(L)))
           - 0.5 * torch.sum(torch.square(alpha)))
    prior = (_lognormal(ls, 0.0, 1.0) + _lognormal(k_var, 0.0, 1.0)
             + _lognormal(var, -2.0, 1.0))
    return lml + torch.sum(prior)


class Predictor:
    """predict_f at the frozen hyperparameters: the factor once, then
    (mean [b, 1], var [b, 1]) for any block of new points."""

    def __init__(self, params, data):
        X, Y = data["X"], data["Y"]
        n = X.shape[0]
        self.X = X
        self.ls, self.k_var, var = _hypers(params)
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        self.L = torch.linalg.cholesky(self.k_var * rbf(X, X, self.ls)
                                       + (var + PREDICT_JITTER) * eye)
        self.alpha = torch.linalg.solve_triangular(self.L, Y, upper=False)

    def __call__(self, x):
        A = torch.linalg.solve_triangular(self.L, self.k_var * rbf(self.X, x, self.ls),
                                          upper=False)  # [n, b]
        mean = A.mT @ self.alpha
        var = torch.clamp(self.k_var - torch.sum(torch.square(A), dim=0), min=0.0)
        return mean, var[:, None]
