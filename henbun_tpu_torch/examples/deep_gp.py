"""Deep GP on a step function, doubly-stochastic SVI at depth 2 and 3 (the
twin of ``examples/deep_gp.py``).

A stationary single-layer GP must trade off the sharp jump against the flat
plateaus; the deep GP warps the input through learned hidden layers
instead. All models get the same inducing budget and training schedule;
compare the reported RMSEs.

Run: python -m henbun_tpu_torch.examples.deep_gp [--iters 6000]
[--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--minibatch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_step_dataset(n=args.n, seed=0)
    grid = np.linspace(-0.9, 0.9, 61).reshape(-1, 1).astype(np.float32)
    truth = (grid[:, 0] > 0).astype(np.float32)
    away = np.abs(grid[:, 0]) > 0.1

    dgp = models.DeepGPRegression(seed=0, X=X, Y=Y, num_inducing=32, device=dev)
    opt = dgp.ELBO()
    opt.compile(hb.adam(0.01))
    opt.optimize(maxiter=args.iters, minibatch_size=args.minibatch)
    dgp_mean = dgp.draws(lambda m: m.predict_f(grid), 128).mean(0).cpu().numpy()[:, 0]
    dgp_rmse = np.sqrt(np.mean((dgp_mean[away] - truth[away]) ** 2))

    svgp = models.SVGPRegression(seed=0, X=X, Y=Y, num_inducing=32, device=dev)
    opt2 = svgp.ELBO()
    opt2.compile(hb.adam(0.01))
    opt2.optimize(maxiter=args.iters, minibatch_size=args.minibatch)
    svgp_mean = svgp.draws(lambda m: m.predict_f(grid)[0], 128).mean(0).cpu().numpy()
    svgp_rmse = np.sqrt(np.mean((svgp_mean[away] - truth[away]) ** 2))

    print("deep GP   RMSE (away from jump): %.4f" % dgp_rmse)
    print("single GP RMSE (away from jump): %.4f" % svgp_rmse)

    # the learned warp: h(x) stretches around the jump
    h = dgp.draws(lambda m: m.hidden(grid), 128).mean(0).cpu().numpy()[:, 0]
    slope_mid = (h[31] - h[29]) / (grid[31, 0] - grid[29, 0])
    slope_edge = (h[-1] - h[-3]) / (grid[-1, 0] - grid[-3, 0])
    print("hidden-layer slope at the jump vs at the edge: %.2f vs %.2f"
          % (slope_mid, slope_edge))

    # depth is a knob: a 3-layer composition on the same budget
    dgp3 = models.DeepGPRegression(seed=0, X=X, Y=Y, num_inducing=32, depth=3, device=dev)
    opt3 = dgp3.ELBO()
    opt3.compile(hb.adam(0.01))
    opt3.optimize(maxiter=args.iters, minibatch_size=args.minibatch)
    d3_mean = dgp3.draws(lambda m: m.predict_f(grid), 128).mean(0).cpu().numpy()[:, 0]
    d3_rmse = np.sqrt(np.mean((d3_mean[away] - truth[away]) ** 2))
    print("3-layer GP RMSE (away from jump): %.4f" % d3_rmse)


if __name__ == "__main__":
    main()
