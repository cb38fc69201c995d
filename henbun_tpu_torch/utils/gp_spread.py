"""The Monte Carlo spread of the GaussianProcess.ipynb fit, measured.

``examples/gaussian_process.py`` trains its first GPR (n = 40, fullrank
q, Adam 0.01) on the single-sample ELBO, so the hyperparameters it ends
with depend on the noise it drew. This script trains `--copies` copies of
that fit together through ``BatchedOptimizer``: the example's data and
initial weights for every copy (``set_seed(0)`` before each), each copy
drawing its own noise, for the example's 20,000 steps. It prints, for the
lengthscale, the kernel variance and the noise variance, the mean, the
standard deviation, the smallest and the largest value over the copies:
the spread against which one run of the example is held to another.

    python -m henbun_tpu_torch.utils.gp_spread [--copies 16] [--iters 20000]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

LEAVES = {
    "lengthscale": lambda m: m.kern.lengthscales.value[0],
    "kernel var": lambda m: m.k_var.value[0],
    "noise var": lambda m: m.var.value[0],
}


def main(argv=None):
    import henbun_tpu_torch as hb
    from henbun_tpu_torch import models

    ap = argparse.ArgumentParser()
    ap.add_argument("--copies", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    ms = []
    for i in range(args.copies):
        hb.set_seed(0)
        X, Y = models.make_sine_dataset(n=40, noise=0.3)
        ms.append(models.GPR(seed=i, X=X, Y=Y, device=dev))
    bo = hb.BatchedOptimizer(ms, "ELBO_gaussian").compile(hb.adam(0.01))
    t0 = time.perf_counter()
    bo.optimize(maxiter=args.iters)
    seconds = time.perf_counter() - t0
    out = {}
    for name, leaf in LEAVES.items():
        v = np.array([float(leaf(m)) for m in ms])
        out[name] = {"mean": float(v.mean()), "sd": float(v.std(ddof=1)),
                     "min": float(v.min()), "max": float(v.max())}
        print("gp_spread: %s over %d copies: mean %.6g sd %.6g min %.6g max %.6g"
              % (name, args.copies, v.mean(), v.std(ddof=1), v.min(), v.max()))
    print("gp_spread: %d copies x %d steps in %.1f s on %s"
          % (args.copies, args.iters, seconds,
             torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"))
    return out


if __name__ == "__main__":
    main()
