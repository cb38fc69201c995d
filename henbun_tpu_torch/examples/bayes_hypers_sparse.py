"""Bayesian hyperparameters over the inducing-point (projected) evidences
(the twin of ``examples/bayes_hypers_sparse.py``).

ML-II (evidence maximization) gives a point estimate of the kernel
hyperparameters; where the evidence surface is not sharp (small data
regions, heavy tails), the full posterior p(theta | y) ~ exp(evidence(theta))
p(theta) is one call away: `models.SparseGPC.log_posterior` bundles the
sparse Laplace evidence with weak lognormal hyperpriors, and
`hb.inference.sample_posterior` runs ChEES-HMC over it. Every chain's
gradient flows through the implicit-function Newton mode; the chains are
one batch, whose small factors and solves go to the hand-written kernels
(K1 and K2) on the card.

Run: python -m henbun_tpu_torch.examples.bayes_hypers_sparse [--n 20000]
[--samples 300] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch.inference import sample_posterior


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (args.n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Y = (rng.uniform(size=X.shape) < p_true).astype(np.float32)

    # ML-II point estimate for contrast
    hb.set_seed(0)
    m_ml = models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=args.m, device=dev)
    opt = m_ml.log_posterior().compile(hb.adam(0.03))
    opt.optimize(maxiter=300)
    print("ML-II: k_var %.3f  lengthscale %.3f" % (
        float(m_ml.k_var.value[0]),
        float(m_ml.gp.kern.lengthscales.value[0]),
    ))

    m = models.SparseGPC(seed=1, X=X, Y=Y, num_inducing=args.m, device=dev)
    res, post, diag = sample_posterior(
        m, "log_posterior", num_chains=args.chains,
        num_samples=args.samples, num_warmup=args.samples,
        sampler="chees", return_diagnostics=True,
        generator=torch.Generator(device=dev).manual_seed(1),
    )
    for path in ("k_var", "gp.kern.lengthscales"):
        d = np.asarray(post[path]).reshape(-1)
        lo, med, hi = np.quantile(d, [0.05, 0.5, 0.95])
        print("%-22s median %.3f  90%% CI [%.3f, %.3f]" % (path, med, lo, hi))
    print("R-hat max %.3f  min bulk ESS %.0f" % (
        diag["rhat_max"], diag["ess_bulk_min"]))


if __name__ == "__main__":
    main()
