"""The SVGP likelihood zoo at minibatch scale: counts, classes, heavy tails
(the twin of ``examples/svgp_likelihoods.py``).

One dataset shape (n points on [0, 6]), three non-Gaussian observation
models, each with the cheapest exact estimator the math allows:

  * Poisson counts     - closed-form lognormal-mean ELBO (`SVGPCount`)
  * 3-class softmax    - reparameterized MC ELBO (`SVGPMulticlass`), the
                         deterministic bound, and the softmax Laplace
                         evidence (`SparseGPMulticlass`)
  * Student-t outliers - per-marginal Gauss-Hermite quadrature
                         (`SVGPRegression.ELBO_student_quadrature`) and the
                         sparse Laplace evidence (`SparseGPRobust`)

Run: python -m henbun_tpu_torch.examples.svgp_likelihoods [--n 20000
--iters 6000] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--minibatch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, size=(args.n, 1))).astype(np.float32)
    grid = np.linspace(0.3, 5.7, 40).reshape(-1, 1).astype(np.float32)
    classes = (np.floor(grid[:, 0]) % 3).astype(int)

    # ---------------- Poisson counts --------------------------------------
    Yp = rng.poisson(np.exp(np.sin(X) + 1.0)).astype(np.float32)
    m = models.SVGPCount(seed=0, X=X, Y=Yp, num_inducing=32, device=dev)
    m.ELBO_analytic().compile(hb.adam(0.02)).optimize(
        maxiter=args.iters, minibatch_size=args.minibatch
    )
    rate, _ = m.run(lambda mm: mm.predict_rate(grid))
    truth = np.exp(np.sin(grid[:, 0]) + 1.0)
    rel = np.abs(rate.cpu().numpy()[:, 0] - truth) / truth
    print("Poisson counts:    median relative rate error %.3f" % np.median(rel))

    # ---------------- 3-class softmax -------------------------------------
    labels = (np.floor(X[:, 0]) % 3).astype(np.int32)[:, None]
    mc = models.SVGPMulticlass(seed=0, X=X, Y=labels, num_classes=3,
                               num_inducing=48, device=dev)
    mc.ELBO().compile(hb.adam(0.02)).optimize(
        maxiter=args.iters, minibatch_size=args.minibatch
    )
    probs = mc.draws(lambda mm: mm.predict_p(grid), 128).mean(0).cpu().numpy()
    acc = np.mean(probs.argmax(-1) == classes)
    print("3-class softmax:   grid accuracy %.3f" % acc)

    # the deterministic multiclass bound (closed-form log-sum-exp Jensen
    # bound) on the same data: no gradient variance
    mb = models.SVGPMulticlass(seed=0, X=X, Y=labels, num_classes=3,
                               num_inducing=48, device=dev)
    mb.ELBO_bound().compile(hb.adam(0.02)).optimize(
        maxiter=args.iters, minibatch_size=args.minibatch
    )
    probs_b = mb.run(lambda mm: mm.predict_p_mean(grid)).cpu().numpy()
    acc_b = np.mean(probs_b.argmax(-1) == classes)
    print("3-class bound:     grid accuracy %.3f (deterministic)" % acc_b)

    # the evidence-trained multiclass path (softmax Laplace, no variational
    # parameters at all)
    ml = models.SparseGPMulticlass(seed=0, X=X, Y=labels, num_classes=3,
                                   num_inducing=48, device=dev)
    ml.log_marginal_laplace().compile(hb.adam(0.05)).optimize(
        maxiter=max(args.iters // 40, 60)
    )
    probs_l = ml.run(lambda mm: mm.predict_p(grid)).cpu().numpy()
    acc_l = np.mean(probs_l.argmax(-1) == classes)
    print("3-class Laplace:   grid accuracy %.3f (evidence-trained)" % acc_l)

    # ---------------- Student-t robustness --------------------------------
    Yr = (np.sin(X) + rng.normal(size=X.shape) * 0.2).astype(np.float32)
    Yr[::25] += 5.0
    mr = models.SVGPRegression(seed=0, X=X, Y=Yr, num_inducing=32, device=dev)
    mr.ELBO_student_quadrature().compile(hb.adam(0.02)).optimize(
        maxiter=args.iters, minibatch_size=args.minibatch
    )
    mean, _ = mr.run(lambda mm: mm.predict_f_marginals(grid))
    rmse = np.sqrt(np.mean((mean.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2))
    print("Student-t robust:  RMSE vs sin(x) %.3f (4%% gross outliers)" % rmse)

    # the deterministic robust path: sparse Laplace evidence, no
    # variational parameters at all
    mrl = models.SparseGPRobust(seed=0, X=X, Y=Yr, num_inducing=32, device=dev)
    mrl.log_marginal_laplace().compile(hb.adam(0.05)).optimize(
        maxiter=max(args.iters // 40, 60)  # full-batch: fewer, fatter steps
    )
    mean_l, _ = mrl.run(lambda mm: mm.predict_f(grid))
    rmse_l = np.sqrt(np.mean((mean_l.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2))
    print("Student-t Laplace: RMSE vs sin(x) %.3f (deterministic evidence)"
          % rmse_l)


if __name__ == "__main__":
    main()
