"""Sparse variational GP at scale with natural gradients (the twin of
``examples/svgp_natgrad.py``).

SVGP over N datapoints with m inducing points, the closed-form
expected-likelihood ELBO (no f sampling), analytic KL, and dual-speed
optimization: natural-gradient steps on the inducing posterior q(u)
(its [m, m] factors and inverses on the hand-written kernels K1 and K2 on
the card), Adam on the kernel and likelihood hyperparameters.

Run: python -m henbun_tpu_torch.examples.svgp_natgrad [--n 100000]
[--iters 2000] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch import optimizers as hopt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--inducing", type=int, default=64)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--minibatch", type=int, default=1024)
    ap.add_argument("--adam-only", action="store_true")
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, size=(args.n, 1)).astype(np.float32), axis=0)
    Y = (np.sin(X) + rng.normal(size=X.shape) * 0.3).astype(np.float32)

    hb.set_seed(0)
    m = models.SVGPRegression(
        seed=0, X=X, Y=Y, num_inducing=args.inducing, analytic_kl=True, device=dev
    )
    opt = m.ELBO_analytic()
    tx = (
        hb.adam(0.02)
        if args.adam_only
        else hopt.natural_gradient(m, gamma=args.gamma, rest=hb.adam(0.02))
    )
    opt.compile(tx)
    t0 = time.perf_counter()
    opt.optimize(maxiter=args.iters, minibatch_size=args.minibatch)
    dt = time.perf_counter() - t0
    objs = np.concatenate(opt.history) / args.n

    grid = np.linspace(0, 6, 200).reshape(-1, 1).astype(np.float32)
    bands = m.draws(lambda mm: mm.predict_f(grid), 100).cpu().numpy()[:, 0, :]
    rmse = float(np.sqrt(np.mean((bands.mean(0) - np.sin(grid[:, 0])) ** 2)))

    print(
        "n=%d  %d steps in %.2f s (%.0f steps/s)  ELBO/n %.4f -> %.4f  "
        "grid RMSE %.3f"
        % (
            args.n,
            args.iters,
            dt,
            args.iters / dt,
            objs[:50].mean(),
            objs[-50:].mean(),
            rmse,
        )
    )


if __name__ == "__main__":
    main()
