"""Amortized Bayesian GP-LVM: unsupervised latent recovery (the twin of
``examples/gplvm.py``).

1000 noisy 3D observations lie on a smooth curve with one generating
coordinate; the GP-LVM learns a 1D latent embedding (encoder-fed, no
per-point parameters) under a sparse-GP decoder and recovers the coordinate
up to sign, reconstructing the data at the noise floor.

Run: python -m henbun_tpu_torch.examples.gplvm [--iters 6000]
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
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--minibatch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    Y, t_true = models.make_curve_dataset(n=args.n, seed=0)
    m = models.GPLVM(seed=0, Y=Y, d_z=1, num_inducing=16, hidden=32, device=dev)
    opt = m.ELBO()
    opt.compile(hb.adam(0.01))
    opt.optimize(maxiter=args.iters, minibatch_size=args.minibatch)

    lat = m.run(lambda mm: mm.latent_mean(Y)).cpu().numpy()[:, 0]
    corr = np.corrcoef(lat, t_true)[0, 1]
    rec = m.draws(lambda mm: mm.reconstruct(Y), 64).mean(0).cpu().numpy()
    rmse = np.sqrt(np.mean((rec - Y) ** 2))
    print("|corr(learned latent, true t)|: %.3f" % abs(corr))
    print("reconstruction RMSE: %.3f (generating noise 0.05)" % rmse)

    # the embedding is a function: held-out rows on the same curve embed
    # consistently without any optimization
    t_new = np.linspace(-1.8, 1.8, 100).astype(np.float32)
    Y_new = np.stack(
        [np.sin(t_new), np.cos(t_new), 0.5 * t_new], axis=1
    ).astype(np.float32)
    lat_new = m.run(lambda mm: mm.latent_mean(Y_new)).cpu().numpy()[:, 0]
    print("held-out |corr|: %.3f" % abs(np.corrcoef(lat_new, t_new)[0, 1]))


if __name__ == "__main__":
    main()
