"""Linear models, MAP and variational: the Henbun_structure and
Henbun_structure2 tutorial workloads (the twin of
``examples/linear_models.py``).

Run: python -m henbun_tpu_torch.examples.linear_models [--map-iters 3000]
[--vi-iters 50000] [--device cpu]. It runs on the card unless
``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--map-iters", type=int, default=3000)
    ap.add_argument("--vi-iters", type=int, default=50000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_linear_dataset(n=200, a=1.0, b=2.0, noise=0.5)

    # --- MAP fit (Henbun_structure.ipynb) ---------------------------------
    m = models.MAPLinearModel(seed=0, X=X, Y=Y, device=dev)
    opt = m.logp()
    opt.compile(hb.adam(0.05))
    opt.optimize(maxiter=args.map_iters)
    print("MAP: a=%.3f b=%.3f" % (float(m.a.value[0]), float(m.b.value[0])))

    # --- VI fit (Henbun_structure2.ipynb: 50k iterations) -----------------
    mv = models.VariationalLinearModel(seed=0, X=X, Y=Y, device=dev)
    vopt = mv.elbo()
    vopt.compile(hb.adam(0.01))
    vopt.optimize(maxiter=args.vi_iters)
    a_mu = float(mv.a.q_mu.free_value[0])
    a_sig = float(torch.exp(mv.a.q_sqrt.free_value)[0])
    b_mu = float(mv.b.q_mu.free_value[0])
    b_sig = float(torch.exp(mv.b.q_sqrt.free_value)[0])
    print("VI:  a=%.3f±%.3f b=%.3f±%.3f" % (a_mu, a_sig, b_mu, b_sig))
    # posterior draws of the fit
    fits = mv.draws(lambda mm: mm.fit(), 30).cpu().numpy()
    print("fit band width (mean std):", fits.std(0).mean())


if __name__ == "__main__":
    main()
