"""Heteroscedastic GP regression: input-dependent noise, two latent GPs
(the twin of ``examples/heteroscedastic.py``).

Fits y = f(x) + eps(x), eps ~ N(0, exp(g(x))), with whitened fullrank
posteriors over both f (the mean) and g (the log noise variance). The
deterministic objective uses the closed-form E[e^{-g}] lognormal identity
(`HeteroscedasticGPR.ELBO_analytic`); the single-sample MC estimator runs
alongside for comparison, and `HeteroSVGP` takes the same closed form to
100x the rows.

Run: python -m henbun_tpu_torch.examples.heteroscedastic [--iters 4000]
[--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y, sd_true = models.make_hetero_dataset(n=args.n, seed=0)

    m = models.HeteroscedasticGPR(seed=0, X=X, Y=Y, device=dev)
    opt = m.ELBO_analytic()
    opt.compile(hb.adam(0.02))
    opt.optimize(maxiter=args.iters)
    print("deterministic ELBO:", float(opt.run()))

    grid = np.linspace(0.2, 5.8, 30).reshape(-1, 1).astype(np.float32)
    fmean, yvar = m.run(lambda mm: mm.predict_y(grid))
    gmean, _ = m.run(lambda mm: mm.predict_g(grid))
    learned_sd = np.exp(0.5 * gmean.cpu().numpy()[:, 0])
    rmse = float(np.sqrt(np.mean((fmean.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2)))
    print("mean RMSE vs sin(x):", rmse)
    lo, hi = learned_sd[grid[:, 0] < 2].mean(), learned_sd[grid[:, 0] > 4].mean()
    print("learned noise sd: quiet region %.3f (true ~0.07), loud %.3f (true ~0.42)"
          % (lo, hi))

    # the single-sample MC estimator on the same data (slower convergence)
    m2 = models.HeteroscedasticGPR(seed=0, X=X, Y=Y, q_shape="diagonal",
                                   analytic_kl=False, device=dev)
    opt2 = m2.ELBO_mc()
    opt2.compile(hb.adam(0.02))
    opt2.optimize(maxiter=args.iters)
    mc = np.mean([float(opt2.run()) for _ in range(20)])
    print("MC ELBO (20-draw mean):", mc)

    # inducing-point scale: the same closed-form objective at 100x the rows
    n_big = max(args.n * 100, 10000)
    Xb, Yb, _ = models.make_hetero_dataset(n=n_big, seed=1)
    mb = models.HeteroSVGP(seed=0, X=Xb, Y=Yb, num_inducing=32, device=dev)
    ob = mb.ELBO_analytic()
    ob.compile(hb.adam(0.02))
    ob.optimize(maxiter=args.iters, minibatch_size=512)
    gb, _ = mb.run(lambda mm: mm.predict_g(grid))
    sdb = np.exp(0.5 * gb.cpu().numpy()[:, 0])
    fb, _ = mb.run(lambda mm: mm.predict_y(grid))
    print("HeteroSVGP n=%d: mean RMSE %.4f, sd quiet %.3f loud %.3f"
          % (n_big,
             float(np.sqrt(np.mean((fb.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2))),
             sdb[grid[:, 0] < 2].mean(), sdb[grid[:, 0] > 4].mean()))


if __name__ == "__main__":
    main()
