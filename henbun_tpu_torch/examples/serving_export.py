"""Train -> export -> serve: the deployment path (the twin of
``examples/serving_export.py``).

Fits the exact-marginal GPR (hyperparameters by evidence maximization),
exports the predictive posterior as a self-contained, batch-polymorphic
``torch.export`` artifact (``henbun_tpu_torch.serving``), saves it, loads it
back with no model object in sight and serves requests of several sizes;
then exports a stochastic posterior-draw artifact whose seed is part of the
request.

Run: python -m henbun_tpu_torch.examples.serving_export [--iters 2000]
[--device cpu]. The model trains on the card unless ``--device cpu``; the
artifact holds a CPU program and, with a card, a CUDA one.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

import henbun_tpu_torch as hb
from henbun_tpu_torch import serving


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    platforms = ("cpu", "cuda") if dev.type == "cuda" else ("cpu",)

    hb.set_seed(0)
    X, Y = hb.models.make_sine_dataset(n=args.n, noise=0.3)

    # 1. train (exact marginal likelihood, hyperparameters only)
    m = hb.models.GPRMarginal(seed=0, X=X, Y=Y, device=dev)
    opt = m.log_marginal().compile(hb.adam(0.05))
    opt.optimize(maxiter=args.iters)
    print("log marginal:", float(opt.run()))

    # 2. export the predictive posterior, batch-polymorphic
    example = np.zeros((8, 1), np.float32)
    art = serving.export_predictor(m, hb.models.GPRMarginal.predict_f, example,
                                   platforms=platforms, batch_polymorphic=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpr_predictor.pt2z")
        art.save(path)
        print("saved artifact:", os.path.getsize(path), "bytes;", art)

        # 3. serve from the file alone (no model, any batch size)
        server_fn = serving.load(path)
        for n_req in (5, 64, 200):
            grid = np.linspace(-1, 7, n_req).reshape(-1, 1).astype(np.float32)
            mean, var = server_fn(torch.tensor(grid, device=dev))
            print("request n=%-4d -> mean[0]=%+.3f  var range [%.3f, %.3f]"
                  % (n_req, float(mean[0, 0]), float(var.min()), float(var.max())))

    # 4. a stochastic artifact: posterior draws with the seed in the request
    mv = hb.models.GPR(seed=0, X=X, Y=Y, q_shape="diagonal", device=dev)
    ov = mv.ELBO_gaussian().compile(hb.adam(0.02))
    ov.optimize(maxiter=args.iters)
    grid = np.linspace(0, 6, 50).reshape(-1, 1).astype(np.float32)
    sampler = serving.export_sampler(mv, hb.models.GPR.predict_f, 32, grid, platforms=platforms)
    draws = sampler(123, torch.tensor(grid, device=dev)).cpu().numpy()
    print("sampler artifact: 32 draws in one call, band width %.3f"
          % float(2 * draws[:, :, 0].std(0).mean()))
    return draws


if __name__ == "__main__":
    main()
