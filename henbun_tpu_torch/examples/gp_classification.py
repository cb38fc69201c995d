"""Binary GP classification five ways, the deterministic engines side by
side on the same generator (the twin of ``examples/gp_classification.py``):

  * exact-gram Laplace (`models.GPC`, inference/laplace.py): Newton mode +
    curvature, evidence-trained hyperparameters;
  * exact-gram expectation propagation (GPC.log_marginal_ep,
    inference/ep.py): moment-matched sites, the accuracy reference;
  * inducing-point SVGP with the deterministic quadrature ELBO and natural
    gradients (`models.SVGPClassification`) for the large-n regime (the
    natural step's factors and inverses on K1 and K2 on the card);
  * inducing-point Laplace (`models.SparseGPC`): evidence-trained
    hyperparameters with no variational parameters, every factorization
    m x m;
  * inducing-point expectation propagation (SparseGPC.log_marginal_ep):
    moment matching at the same O(n m^2) per sweep, trained under the
    ep_delta convergence guard.

Run: python -m henbun_tpu_torch.examples.gp_classification [--n-exact 120]
[--n-svgp 20000] [--device cpu]. It runs on the card unless
``--device cpu``.
"""
import argparse

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch import optimizers as hopt


def make_labels(n, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, n)).astype(np.float32)[:, None]
    p = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Y = (rng.uniform(size=X.shape) < p).astype(np.float32)
    return X, Y


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-exact", type=int, default=120)
    ap.add_argument("--n-svgp", type=int, default=20000)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    grid = np.linspace(-3, 3, 61, dtype=np.float32)[:, None]
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(grid[:, 0])))

    def report(name, p):
        p = p.cpu().numpy() if isinstance(p, torch.Tensor) else p
        err = float(np.abs(p[:, 0] - p_true).mean())
        sure = np.abs(p_true - 0.5) > 0.15
        acc = float((((p[:, 0] > 0.5) == (p_true > 0.5))[sure]).mean())
        print("%-28s mean |p - p_true| %.4f   decision acc (sure region) %.3f"
              % (name, err, acc))

    # --- exact-gram engines on the same small dataset ----------------------
    X, Y = make_labels(args.n_exact, seed=0)

    m_lp = models.GPC(seed=0, X=X, Y=Y, device=dev)
    o = m_lp.log_marginal_laplace()
    o.compile(hb.adam(0.05))
    o.optimize(maxiter=args.iters)
    print("Laplace evidence:", float(o.run()))
    report("GPC Laplace", m_lp.run(lambda mm: mm.predict_p(grid)))

    m_ep = models.GPC(seed=0, X=X, Y=Y, device=dev)
    o = m_ep.log_marginal_ep()
    o.compile(hb.adam(0.05))
    o.optimize(maxiter=args.iters)
    res = m_ep.run(lambda mm: mm.ep())
    print("EP evidence: %.3f  (last-sweep site delta %.2e)"
          % (float(res.log_marginal), float(res.delta)))
    report("GPC EP", m_ep.run(lambda mm: mm.predict_p_ep(grid)))

    # --- inducing-point scale: deterministic quadrature ELBO + natgrad -----
    Xl, Yl = make_labels(args.n_svgp, seed=1)
    m_sv = models.SVGPClassification(seed=0, X=Xl, Y=Yl, num_inducing=64, device=dev)
    opt = m_sv.ELBO_quadrature()
    opt.compile(hopt.natural_gradient(m_sv, gamma=0.1, rest=hb.adam(0.01)))
    opt.optimize(maxiter=8 * args.iters, minibatch_size=512,
                 minibatch_mode="block")
    p_draws = m_sv.draws(lambda mm: mm.predict_p(grid)[0], 200)
    report("SVGP quadrature+natgrad", p_draws.mean(0)[:, None])

    # --- inducing-point Laplace: deterministic evidence at the same n ------
    m_sl = models.SparseGPC(seed=0, X=Xl, Y=Yl, num_inducing=64, device=dev)
    opt = m_sl.log_marginal_laplace()
    opt.compile(hb.adam(0.05))
    opt.optimize(maxiter=args.iters)  # full-batch: each step sees all n rows
    print("Sparse Laplace evidence/n: %.4f"
          % (float(opt.run()) / args.n_svgp))
    report("SparseGPC Laplace", m_sl.run(lambda mm: mm.predict_p(grid)))

    # --- inducing-point EP: the moment-matched accuracy reference at n -----
    m_se = models.SparseGPC(seed=0, X=Xl, Y=Yl, num_inducing=64, device=dev)
    opt = m_se.log_marginal_ep()
    opt.compile(hb.adam(0.05))
    opt.optimize(maxiter=args.iters)
    print("Sparse EP evidence/n: %.4f  (ep_delta %.2e)"
          % (float(opt.run()) / args.n_svgp,
             opt.metrics.rows[-1]["ep_delta"]))
    report("SparseGPC EP", m_se.run(lambda mm: mm.predict_p_ep(grid)))


if __name__ == "__main__":
    main()
