"""Fleet training: N independent model fits in one step loop, and the same
fleet sharded over a device mesh (the twin of ``examples/fleet.py``).

``BatchedOptimizer`` stacks N structurally identical models (per-dataset
fits, per-fold cross-validation, per-restart inits) and advances all of
them each step; their [N, n, n] factors and solves go to the hand-written
kernels (K1 and K2) on the card. ``ShardedBatchedOptimizer`` splits the
model axis over the mesh's 'chain' dimension: every rank of the
``torch.distributed`` world trains its block of the fleet. In one process
the mesh is a one-rank group.

Run: python -m henbun_tpu_torch.examples.fleet [--models 16] [--iters 4000]
[--use-pallas] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch.batched import BatchedOptimizer
from henbun_tpu_torch.parallel import ShardedBatchedOptimizer, make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", type=int, default=16)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--use-pallas", action="store_true",
                    help="send the fleet's factors and solves to the hand-written "
                         "kernels ([cuda] use_kernels, on by default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.use_pallas:
        hb.settings.cuda.use_kernels = True

    hb.set_seed(0)

    def fleet():
        ms = []
        for i in range(args.models):
            X, Y = models.make_sine_dataset(n=args.n, seed=i)
            ms.append(models.GPR(seed=i, X=X, Y=Y, analytic_kl=True, device=dev))
        return ms

    # ---- one card: N fits in one step loop ------------------------------
    ms = fleet()
    bo = BatchedOptimizer(ms, "ELBO_gaussian")
    bo.compile(hb.adam(0.01))
    t0 = time.time()
    bo.optimize(maxiter=args.iters)
    dt = time.time() - t0
    tail = np.asarray(bo.history[-1])[-50:].mean()
    print("batched x%d: %d steps in %.2fs (%.0f model-steps/s), "
          "summed tail ELBO %.1f"
          % (args.models, args.iters, dt, args.models * args.iters / dt, tail))

    # every model ends with its own learned hyperparameters
    ls = [float(m.kern.lengthscales.value[0]) for m in ms]
    print("per-model lengthscales: min %.3f  median %.3f  max %.3f"
          % (min(ls), float(np.median(ls)), max(ls)))

    # ---- mesh: the same fleet sharded over the 'chain' dimension --------
    owns_group = not dist.is_initialized()
    n_dev = 1 if owns_group else dist.get_world_size()
    n_chain = n_dev if args.models % n_dev == 0 else 1
    mesh = make_mesh(n_data=n_dev // n_chain, n_chain=n_chain, device_type=dev.type)
    try:
        sb = ShardedBatchedOptimizer(fleet(), "ELBO_gaussian", mesh=mesh)
        sb.compile(hb.adam(0.01))
        t0 = time.time()
        sb.optimize(maxiter=args.iters)
        dt = time.time() - t0
    finally:
        if owns_group:
            dist.destroy_process_group()
    tail_sb = np.asarray(sb.history[-1])[-50:].mean()
    print("sharded over %d device(s) on the 'chain' axis: %d steps in %.2fs, "
          "summed tail ELBO %.1f" % (n_chain, args.iters, dt, tail_sb))


if __name__ == "__main__":
    main()
