"""Large-scale amortized SVI, BASELINE.json config 3: encoder-fed local
variational parameters, minibatch SVI on a synthetic 1e6-point regression
(the twin of ``examples/amortized_svi.py``). ``--sharded`` trains
data-parallel over the ranks of the ``torch.distributed`` world (one rank
in one process).

Run: python -m henbun_tpu_torch.examples.amortized_svi [--n 1000000]
[--sharded] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--minibatch", type=int, default=1024)
    ap.add_argument("--d-z", type=int, default=4)
    ap.add_argument("--q-local", default="diagonal",
                    choices=["diagonal", "fullrank_packed"],
                    help="local posterior family; fullrank_packed gives "
                         "correlated d_z-dim locals from a slab of "
                         "d_z + d_z(d_z+1)/2 encoder outputs (half the "
                         "dense layout's width)")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_synthetic_regression(n=args.n, d_x=8)
    m = models.AmortizedRegression(
        seed=0, X=X, Y=Y, d_z=args.d_z, hidden=64, q_local=args.q_local, device=dev
    )

    owns_group = args.sharded and not dist.is_initialized()
    try:
        if args.sharded:
            from henbun_tpu_torch.parallel import make_mesh, ShardedOptimizer

            n_dev = 1 if owns_group else dist.get_world_size()
            mesh = make_mesh(n_data=n_dev, n_chain=1, device_type=dev.type)
            opt = ShardedOptimizer(m, "ELBO", mesh=mesh)
            opt.compile(hb.adam(0.003))
        else:
            opt = m.ELBO()
            opt.compile(hb.adam(0.003))

        opt.optimize(maxiter=500, minibatch_size=args.minibatch)  # warm up
        t0 = time.time()
        opt.optimize(maxiter=args.iters, minibatch_size=args.minibatch)
        dt = time.time() - t0
    finally:
        if owns_group:
            dist.destroy_process_group()
    per_elbo = np.concatenate(opt.history)[-100:].mean() / m.n_data
    print("steps/s: %.1f   examples/s: %.0f" % (args.iters / dt, args.iters / dt * args.minibatch))
    print("per-datapoint ELBO: %.4f" % per_elbo)


if __name__ == "__main__":
    main()
