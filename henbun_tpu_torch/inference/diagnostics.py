"""Sampler diagnostics: effective sample size, split R-hat, divergences.

A numpy copy of the JAX package's ``inference/diagnostics.py``, identical
in results; ``[verbosity] hmc_verb`` gates the report (see :func:`report`
and ``api.sample_posterior``).

Estimators follow Vehtari, Gelman, Simpson, Carpenter & Buerkner (2021),
"Rank-normalization, folding, and localization: an improved R-hat for
assessing convergence of MCMC": split chains, rank-normalized bulk ESS, and
Geyer's initial-positive-sequence truncation of the autocorrelation sum.
Everything is host-side numpy on the gathered samples: diagnostics read a
[num_samples, num_chains, dim] array once; no device work.
"""
from __future__ import annotations

import numpy as np

from .._settings import settings


def _as_scd(samples):
    """Coerce to [n_samples, n_chains, dim] float64."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 2:  # [n, chains] -> one dim
        x = x[:, :, None]
    if x.ndim != 3:
        raise ValueError(
            "samples must be [num_samples, num_chains, dim]; got shape %s"
            % (x.shape,)
        )
    return x


def _split_chains(x):
    """Split each chain in half: [n, c, d] -> [n//2, 2c, d] (discards the
    middle sample when n is odd)."""
    n = x.shape[0]
    half = n // 2
    return np.concatenate([x[:half], x[n - half :]], axis=1)


def _rank_normalize(x):
    """Fractional ranks over ALL samples/chains per dim, mapped through the
    normal quantile function (Vehtari et al. 2021, eq. 14: (r - 3/8)/(S + 1/4))."""
    from scipy.special import ndtri

    n, c, d = x.shape
    flat = x.reshape(n * c, d)
    ranks = np.empty_like(flat)
    order = np.argsort(flat, axis=0)
    rr = np.arange(1, n * c + 1, dtype=np.float64)[:, None]
    np.put_along_axis(ranks, order, np.broadcast_to(rr, flat.shape), axis=0)
    z = ndtri((ranks - 0.375) / (n * c + 0.25))
    return z.reshape(n, c, d)


def _autocov_fft(x):
    """Biased per-chain autocovariance via FFT. x: [n, c, d] -> [n, c, d]."""
    n = x.shape[0]
    y = x - x.mean(axis=0, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(y, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n]
    return acov.real / n


def effective_sample_size(samples):
    """Per-chain Geyer ESS, summed over chains. samples: [n, c, d] -> [d].

    Per-chain initial-positive-sequence autocorrelation time, chains
    treated as independent streams, FFT-vectorized: O(c d n log n).
    """
    x = _as_scd(samples)
    n, c, d = x.shape
    acov = _autocov_fft(x)  # [n, c, d]
    var0 = acov[0]
    safe = var0 > 0
    rho = np.where(safe[None], acov / np.where(safe, var0, 1.0)[None], 0.0)
    # pair sums rho[2k-1] + rho[2k]; keep while the running sequence stays
    # positive (Geyer initial positive sequence)
    npairs = (n - 1) // 2
    if npairs < 1:
        return np.full(d, float(c))
    pairs = rho[1 : 2 * npairs : 2] + rho[2 : 2 * npairs + 1 : 2]  # [npairs,c,d]
    pos = np.cumprod(pairs > 0, axis=0).astype(bool)
    tau = 1.0 + 2.0 * np.sum(np.where(pos, pairs, 0.0), axis=0)  # [c, d]
    per_chain = np.where(safe, n / np.maximum(tau, 1.0), 1.0)
    return per_chain.sum(axis=0)


def ess_bulk(samples):
    """Bulk ESS (Vehtari et al. 2021): rank-normalized split chains, combined
    multi-chain autocorrelation. samples: [n, c, d] -> [d]."""
    z = _rank_normalize(_split_chains(_as_scd(samples)))
    n, m, d = z.shape
    if n < 4:
        raise ValueError("need at least 4 samples per chain for ess_bulk")
    acov = _autocov_fft(z)  # [n, m, d]
    chain_var = acov[0] * n / (n - 1.0)  # [m, d]
    w = chain_var.mean(axis=0)  # within-chain variance
    mean_acov = acov.mean(axis=1)  # [n, d]
    if m > 1:
        b_over_n = z.mean(axis=0).var(axis=0, ddof=1)  # B/n
        var_plus = w * (n - 1.0) / n + b_over_n
    else:
        var_plus = w * (n - 1.0) / n
    rho = 1.0 - (w[None] - mean_acov) / var_plus[None]  # [n, d]
    npairs = (n - 1) // 2
    pairs = rho[1 : 2 * npairs : 2] + rho[2 : 2 * npairs + 1 : 2]  # [npairs, d]
    pos = np.cumprod(pairs > 0, axis=0).astype(bool)
    # monotone decrease enforcement on the kept pairs
    kept = np.where(pos, pairs, 0.0)
    kept = np.minimum.accumulate(np.where(pos, pairs, np.inf), axis=0)
    kept = np.where(pos, np.maximum(kept, 0.0), 0.0)
    tau = -1.0 + 2.0 * (1.0 + kept.sum(axis=0))  # rho_0 = 1 pairs with rho_1…
    tau = np.maximum(tau, 1.0 / np.log10(n * m + 10.0))
    return n * m / tau


def split_rhat(samples, rank_normalized=True):
    """Split-chain potential scale reduction factor. samples: [n,c,d] -> [d].

    With ``rank_normalized`` (default) this is the bulk R-hat of Vehtari et
    al. 2021; values above ~1.01 indicate non-convergence.
    """
    x = _split_chains(_as_scd(samples))
    if rank_normalized:
        x = _rank_normalize(x)
    n, m, d = x.shape
    if m < 2:
        raise ValueError("split_rhat needs at least 1 chain with >= 2 samples")
    chain_mean = x.mean(axis=0)  # [m, d]
    w = x.var(axis=0, ddof=1).mean(axis=0)  # within
    b = n * chain_mean.var(axis=0, ddof=1)  # between
    var_plus = (n - 1.0) / n * w + b / n
    return np.sqrt(var_plus / np.where(w > 0, w, 1.0))


def divergence_mask(accept_prob):
    """Boolean [n, c] mask of divergent transitions.

    The HMC-family kernels map a non-finite trajectory energy to
    ``log_accept = -inf`` (``hmc._transition``), so ``accept_prob == 0`` identifies
    exactly the transitions whose proposal blew up — for a continuous target
    a genuinely finite trajectory has accept probability > 0.
    """
    return np.asarray(accept_prob) == 0.0


def divergence_count(accept_prob):
    """Total number of divergent transitions across chains."""
    return int(divergence_mask(accept_prob).sum())


def summarize(samples, accept_prob=None):
    """One-stop diagnostics dict for a sampler result.

    Returns min/median bulk ESS, max split R-hat, divergence count/rate and
    mean acceptance — the quantities a run must clear before its samples are
    trusted.
    """
    x = _as_scd(samples)
    ess = ess_bulk(x)
    rhat = split_rhat(x)
    out = {
        "num_samples": int(x.shape[0]),
        "num_chains": int(x.shape[1]),
        "dim": int(x.shape[2]),
        "ess_bulk_min": float(ess.min()),
        "ess_bulk_median": float(np.median(ess)),
        "rhat_max": float(rhat.max()),
    }
    if accept_prob is not None:
        a = np.asarray(accept_prob)
        out["accept_mean"] = float(a.mean())
        out["divergences"] = divergence_count(a)
        out["divergence_rate"] = float(divergence_mask(a).mean())
    return out


def report(summary, prefix="[henbun mcmc]"):
    """Print a one-line diagnostics report, gated on [verbosity] hmc_verb
    (0 = silent; >=1 = summary line; >=2 adds a warning breakdown)."""
    verb = int(settings.verbosity.hmc_verb)
    if verb < 1:
        return
    line = (
        "%s %d samples x %d chains (dim %d): ess_bulk min %.0f / median %.0f,"
        " rhat_max %.4f"
        % (
            prefix,
            summary["num_samples"],
            summary["num_chains"],
            summary["dim"],
            summary["ess_bulk_min"],
            summary["ess_bulk_median"],
            summary["rhat_max"],
        )
    )
    if "divergences" in summary:
        line += ", %d divergences, accept %.2f" % (
            summary["divergences"],
            summary["accept_mean"],
        )
    print(line)
    if verb >= 2:
        if summary["rhat_max"] > 1.01:
            print("%s WARNING: rhat_max > 1.01 — chains have not mixed" % prefix)
        if summary.get("divergence_rate", 0.0) > 0.001:
            print(
                "%s WARNING: divergence rate %.2g — reduce step size or "
                "reparameterize" % (prefix, summary["divergence_rate"])
            )
