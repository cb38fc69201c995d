"""Multi-output GP regression, a linear model of coregionalization (the
twin of ``examples/multioutput.py``).

Three correlated outputs generated by two latent functions (sin, cos)
through a fixed mixing matrix; the model learns Q=2 latent GPs and a
trainable [3, 2] mixing, recovering every output and the cross-output
correlation structure, with the latent axis as a leading batch dimension
(batched Cholesky), not an nP x nP coregionalized gram.

Run: python -m henbun_tpu_torch.examples.multioutput [--iters 20000]
[--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--n", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y, F = models.make_multioutput_dataset(n=args.n, seed=0)

    m = models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, device=dev)
    opt = m.ELBO_analytic()
    opt.compile(hb.adam(0.02))
    opt.optimize(maxiter=args.iters)
    print("ELBO:", float(opt.run()))

    grid = np.linspace(0.2, 5.8, 50).reshape(-1, 1).astype(np.float32)
    W = np.array([[1.0, 0.0], [0.8, 0.6], [-0.9, 0.4]], np.float32)
    truth = np.concatenate([np.sin(grid), np.cos(grid)], 1) @ W.T
    mean, var = m.run(lambda mm: mm.predict_y(grid))
    mean = mean.cpu().numpy()
    for p in range(3):
        rmse = np.sqrt(np.mean((mean[:, p] - truth[:, p]) ** 2))
        print("output %d: predictive RMSE %.3f" % (p, rmse))

    C = m.run(lambda mm: mm.output_correlation()).cpu().numpy()
    print("model-implied output correlations:\n", np.round(C, 2))
    print("learned noise stds:", np.round(np.sqrt(m.var.value), 3))

    # inducing-point scale: sparse LMC at 100x the rows, minibatched
    n_big = max(args.n * 100, 10000)
    Xb, Yb, _ = models.make_multioutput_dataset(n=n_big, seed=1)
    mb = models.MultiOutputSVGP(seed=0, X=Xb, Y=Yb, Q=2, num_inducing=32, device=dev)
    ob = mb.ELBO_analytic()
    ob.compile(hb.adam(0.02))
    ob.optimize(maxiter=max(args.iters // 4, 1000), minibatch_size=512)
    meanb, _ = mb.run(lambda mm: mm.predict_f(grid))
    meanb = meanb.cpu().numpy()
    for p_ in range(3):
        rmse = np.sqrt(np.mean((meanb[:, p_] - truth[:, p_]) ** 2))
        print("MultiOutputSVGP n=%d output %d: RMSE %.3f" % (n_big, p_, rmse))
    gridC = np.linspace(0.2, 5.8, 400).reshape(-1, 1).astype(np.float32)
    Cb = mb.run(lambda mm: mm.output_correlation(gridC)).cpu().numpy()
    print("sparse function-space output correlations:\n", np.round(Cb, 2))


if __name__ == "__main__":
    main()
