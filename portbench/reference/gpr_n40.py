"""float64 reference of ``gpr_n40``: the GaussianProcess.ipynb ELBO
(``GPR.ELBO_gaussian``, fullrank q over the whitened latent, unit RBF,
Gaussian likelihood) of every model of a fleet, from its equations:

    s = scale (raw = q_mu + tril(q_sqrt) u),  q = s raw
    L = chol(K(X) + 1e-4 max(1, n/96) I),  f = sqrt(k_var) L q
    ELBO = sum_i log N(y_i | f_i, var) - KL,
    KL = -1/2 sum_i (log(diag(q_sqrt)_i^2 + 1e-20) + u_i^2 - raw_i^2)

The KL is the single-sample estimate of the port's ``Normal._KL`` (the
N(0, I) prior's log density against q's at the same sample).
"""
from __future__ import annotations

import math

import torch

from .common import positive, rbf

JITTER_LEVEL = 1e-4  # henbunrc [numerics] jitter_level


def objective(params, data, noise, matmul=torch.matmul):
    """Per-model ELBO [B]: params {path: [B, ...]} free values, data
    {"X", "Y": [B, n, 1]}, noise {"q": [B, n]}, all float64 (float32 with
    ``common.tf32_matmul`` for the control)."""
    X, Y, u = data["X"], data["Y"], noise["q"]
    n = X.shape[-2]
    ls = positive(params["kern.lengthscales"])[:, None, :]  # [B, 1, 1]
    k_var = positive(params["k_var"])[:, :, None]
    var = positive(params["var"])[:, :, None]
    scale = positive(params["q.scale"])  # [B, 1, 1]
    q_sqrt = params["q.q_sqrt"]
    raw = params["q.q_mu"] + matmul(torch.tril(q_sqrt), u[..., None])[..., 0]  # [B, n]
    q = scale * raw[..., None]  # [B, n, 1]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(rbf(X, X, ls) + JITTER_LEVEL * max(1.0, n / 96.0) * eye)
    f = torch.sqrt(k_var) * matmul(L, q)
    ll = torch.sum(-0.5 * math.log(2 * math.pi) - 0.5 * torch.log(var)
                   - 0.5 * torch.square(f - Y) / var, dim=(1, 2))
    logdet = torch.log(torch.square(torch.diagonal(q_sqrt, dim1=-2, dim2=-1)) + 1e-20)
    kl = -0.5 * torch.sum(logdet + torch.square(u) - torch.square(raw), dim=-1)
    return ll - kl
