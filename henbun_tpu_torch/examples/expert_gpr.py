"""Mixture-of-experts GP regression, the Expert_GPR.ipynb workload (the
twin of ``examples/expert_gpr.py``): short- and long-lengthscale GPs gated
by a third sigmoid GP, initialized by a single-GP fit under a temporarily
raised jitter (a scoped settings override).

Run: python -m henbun_tpu_torch.examples.expert_gpr [--init-iters 3000]
[--rounds 10] [--iters 1000] [--device cpu]. It runs on the card unless
``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-iters", type=int, default=3000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_expert_dataset(n=args.n)
    m = models.ExpertGPR(seed=0, X=X, Y=Y, device=dev)

    # initial single-GP estimate under a scoped settings override
    cfg = hb.settings.get_settings()
    cfg.numerics.jitter_level = 3e-4
    with hb.settings.temp_settings(cfg):
        init = m.ELBO_single()
        init.compile(hb.adam(0.01))
        init.optimize(maxiter=args.init_iters)
    print("single-GP ELBO:", float(init.run()))

    main_opt = m.ELBO()
    main_opt.compile(hb.adam(0.001))
    # the notebook runs 10 x 1000 iterations with live plotting
    for _ in range(args.rounds):
        main_opt.optimize(maxiter=args.iters)
        print("ELBO:", float(main_opt.run()))

    draws = m.draws(lambda mm: mm.f_mixture(), 30).cpu().numpy()
    rmse = np.sqrt(np.mean((draws.mean(0) - Y) ** 2))
    print("fit RMSE:", rmse)
    return rmse


if __name__ == "__main__":
    main()
