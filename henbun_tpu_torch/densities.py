"""Elementwise log-density functions (the 11 densities of the JAX package),
on tensors. ``bernoulli`` takes (p, y) and selects p or 1 - p;
``bernoulli_logit`` takes the labels and the logit, the classifier's
likelihood (inlined in the JAX package's Laplace engine and GPC)."""
from __future__ import annotations

import numpy as np
import torch

from ._settings import settings
from .ops.linalg import log_sum_exp, tri_solve


def _tensors(*args):
    """The arguments as tensors: numpy arrays and Python numbers (fixed
    hyperparameters) take the dtype and device of the first tensor among
    them. A number is filled in on the device (``torch.full``), not copied
    from the host: a host-to-device copy of a pageable number synchronizes
    the host with the device at every call."""
    like = next(a for a in args if isinstance(a, torch.Tensor))
    return [
        a if isinstance(a, torch.Tensor)
        else torch.full((), float(a), dtype=like.dtype, device=like.device) if np.ndim(a) == 0
        else torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
        for a in args
    ]


def gaussian(x, mu, var):
    x, mu, var = _tensors(x, mu, var)
    return (
        -0.5 * np.log(2 * np.pi)
        - 0.5 * torch.log(var)
        - 0.5 * torch.square(mu - x) / var
    )


def lognormal(x, mu, var):
    x, mu, var = _tensors(x, mu, var)
    lnx = torch.log(x)
    return gaussian(lnx, mu, var) - lnx


def bernoulli(p, y):
    return torch.log(torch.where(y == 1, p, 1 - p))


def bernoulli_logit(y, f):
    """log p(y | f) = y log sigmoid(f) + (1-y) log sigmoid(-f) for labels
    y in {0, 1}, with log sigmoid(x) = -softplus(-x), stable at large |f|.
    (Not ``logsigmoid``: its saved buffer breaks the Laplace IFT's gradient
    of a gradient under ``torch.func.vmap``.)"""
    softplus = torch.nn.functional.softplus
    return -y * softplus(-f) - (1.0 - y) * softplus(f)


def poisson(lamb, y):
    return y * torch.log(lamb) - lamb - torch.lgamma(y + 1.0)


def exponential(lamb, y):
    return -y / lamb - torch.log(lamb)


def gamma(shape, scale, x):
    shape, scale, x = _tensors(shape, scale, x)
    return (
        -shape * torch.log(scale)
        - torch.lgamma(shape)
        + (shape - 1.0) * torch.log(x)
        - x / scale
    )


def student_t(x, mean, scale, deg_free):
    x, mean, scale, deg_free = _tensors(x, mean, scale, deg_free)
    deg_free = deg_free.to(settings.dtypes.float_type)
    const = (
        torch.lgamma((deg_free + 1.0) * 0.5)
        - torch.lgamma(deg_free * 0.5)
        - 0.5 * (torch.log(torch.square(scale)) + torch.log(deg_free) + np.log(np.pi))
    )
    return const - 0.5 * (deg_free + 1.0) * torch.log(
        1.0 + (1.0 / deg_free) * (torch.square((x - mean) / scale))
    )


def beta(alpha, beta, y):
    # clip y away from {0, 1} since log of 0 is nan
    y = torch.clamp(y, 1e-6, 1 - 1e-6)
    alpha, beta = _tensors(alpha, beta, y)[:2]
    return (
        (alpha - 1.0) * torch.log(y)
        + (beta - 1.0) * torch.log(1.0 - y)
        + torch.lgamma(alpha + beta)
        - torch.lgamma(alpha)
        - torch.lgamma(beta)
    )


def laplace(mu, sigma, y):
    mu, sigma, y = _tensors(mu, sigma, y)
    return -torch.abs(mu - y) / sigma - torch.log(2.0 * sigma)


def multivariate_normal(x, mu, L):
    """Multivariate normal log density given the Cholesky factor L of the
    covariance. x, mu are vectors or [n, k] matrices (independent columns);
    the row count must match the size of L."""
    d = x - mu
    d2 = d[:, None] if d.ndim == 1 else d
    alpha = tri_solve(L, d2)
    num_col = 1 if x.ndim == 1 else x.shape[1]
    num_dims = x.shape[0]
    ret = -0.5 * num_dims * num_col * np.log(2 * np.pi)
    ret = ret - num_col * torch.sum(torch.log(torch.diagonal(L)))
    ret = ret - 0.5 * torch.sum(torch.square(alpha))
    return ret


def bimixture(fraction, logp0, logp1):
    """log(fraction*exp(logp0) + (1-fraction)*exp(logp1)), stable."""
    return log_sum_exp(
        torch.stack(
            [logp0 + torch.log(fraction), logp1 + torch.log(1.0 - fraction)],
            dim=-1,
        ),
        axis=-1,
    )
