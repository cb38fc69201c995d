"""GP regression with variational inference, the GaussianProcess.ipynb
workload end to end (the twin of ``examples/gaussian_process.py``).

Fits y = f(x) + noise with a whitened fullrank variational posterior over f,
then refits with a Student-t likelihood for robustness to outliers: by the
Monte Carlo ELBO, by the deterministic quadrature ELBO under natural
gradients, and by the Laplace evidence.

Run: python -m henbun_tpu_torch.examples.gaussian_process [--iters 20000]
[--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch import optimizers as hopt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_sine_dataset(n=40, noise=0.3)
    m = models.GPR(seed=0, X=X, Y=Y, device=dev)

    opt = m.ELBO_gaussian()
    opt.compile(hb.adam(0.01))
    opt.optimize(maxiter=args.iters)
    print("ELBO:", float(opt.run()))
    print("lengthscale:", m.kern.lengthscales.value)
    print("kernel var:", m.k_var.value, " noise var:", m.var.value)

    # posterior draws of f at X
    draws = m.draws(lambda mm: mm.f_sample(), 100).cpu().numpy()
    rmse = np.sqrt(np.mean((draws.mean(0) - np.sin(X)) ** 2))
    print("posterior-mean RMSE vs sin(x):", rmse)

    # prediction at new inputs
    grid = np.linspace(0, 6, 120).reshape(-1, 1).astype(np.float32)
    bands = m.draws(lambda mm: mm.predict_f(grid), 100).cpu().numpy()[:, :, 0]
    print("predictive band mean width:", 2 * bands.std(0).mean())

    # --- robust variant: Student-t likelihood against outliers ----------
    Y_out = Y.copy()
    Y_out[::8] += 3.0
    m2 = models.GPR(seed=0, X=X, Y=Y_out, device=dev)
    opt2 = m2.ELBO_student()
    opt2.compile(hb.adam(0.01))
    opt2.optimize(maxiter=args.iters // 2)
    print("robust ELBO:", float(opt2.run()))

    # the deterministic objective (Gauss-Hermite expected Student-t
    # log-likelihood + analytic KL) under dual-speed natural gradients
    m3 = models.GPR(seed=0, X=X, Y=Y_out, analytic_kl=True, device=dev)
    opt3 = m3.ELBO_student_quadrature()
    opt3.compile(hopt.natural_gradient(m3, gamma=0.2, rest=hb.adam(0.02)))
    opt3.optimize(maxiter=max(800, args.iters // 20))
    print("robust ELBO (quadrature+natgrad):", float(opt3.run()))

    # Laplace: hyperparameters trained on the Newton-mode evidence, the
    # latent posterior (mean and variance) read deterministically
    m4 = models.GPR(seed=0, X=X, Y=Y_out, device=dev)
    opt4 = m4.log_marginal_laplace_student()
    opt4.compile(hb.adam(0.02))
    opt4.optimize(maxiter=max(600, args.iters // 20))
    print("robust Laplace evidence:", float(opt4.run()))
    grid = np.linspace(X.min(), X.max(), 100, dtype=np.float32)[:, None]
    mean, var = m4.run(lambda mm: mm.predict_f_laplace(grid))
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2)))
    print("robust Laplace posterior-mean RMSE vs sin(x):", rmse)


if __name__ == "__main__":
    main()
