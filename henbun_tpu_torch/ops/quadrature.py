"""Gauss-Hermite expectations under Gaussian marginals:

    E[g(f_i)] ~= 1/sqrt(pi) * sum_k w_k g(mean_i + sqrt(2 var_i) x_k)

with (x_k, w_k) the Gauss-Hermite nodes (deg = 20 is exact for polynomials
to degree 39). Deterministic, unlike a Monte Carlo estimate."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _nodes(deg):
    x, w = np.polynomial.hermite.hermgauss(deg)
    return x.astype(np.float64), (w / np.sqrt(np.pi)).astype(np.float64)


def gauss_hermite_expectation(log_density, f_mean, f_var, deg=20):
    """Elementwise E_{f ~ N(f_mean, f_var)}[log_density(f)].

    log_density must be vectorized: it receives a tensor shaped
    ``f_mean.shape + (deg,)`` and returns elementwise values (close over
    the observations with a trailing broadcast axis, e.g. ``y[..., None]``).
    """
    x, w = _nodes(int(deg))
    x = torch.as_tensor(x, dtype=f_mean.dtype, device=f_mean.device)
    w = torch.as_tensor(w, dtype=f_mean.dtype, device=f_mean.device)
    pts = f_mean[..., None] + torch.sqrt(2.0 * f_var)[..., None] * x
    return torch.sum(w * log_density(pts), dim=-1)
