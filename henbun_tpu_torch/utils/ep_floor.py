"""The projected EP's floor at inducing-point scale, measured.

``inference/ep.py::_floored`` floors P = I + A^T T A at the Laplace
engine's scale-aware base, 1e-6 (1 + max diag P), its gradient stopped;
the JAX package uses the jitter level (1e-4) as that base. This script
runs ``SparseGPC`` at n = 1e5, m = 128 (the data of ``chip_smoke.py``'s
sparse phase: sorted U[0, 6] inputs, labels from sigmoid(3 sin x), numpy
seed 0) under three floors:

* ``port``: base 1e-6, gradient stopped (what the port runs);
* ``reference``: base 1e-4, gradient stopped (the JAX package's);
* ``reference_kept``: base 1e-4, gradient kept.

For each it prints, at the initial weights, the EP evidence and its
gradients in float32 and float64 beside the Laplace evidence, then the
per-row evidence over 100 Adam (0.05) steps in float32: its first and last
10-step means, the fitted k_var and lengthscale, and the last ep_delta.

    python -m henbun_tpu_torch.utils.ep_floor [--n 100000] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

FLOORS = {
    "port": (1e-6, True),
    "reference": (1e-4, True),
    "reference_kept": (1e-4, False),
}


def sparse_gpc_data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p_true).astype(np.float32)


@contextlib.contextmanager
def floor(base, stopped):
    """Run the projected EP with the given floor base, its gradient stopped
    or kept."""
    from ..inference import ep, laplace

    def floored(P):
        if stopped:
            return laplace._with_floor(P, base)
        eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
        return P + laplace._floor_jitter(P, base) * eye

    real = ep._floored
    ep._floored = floored
    try:
        yield
    finally:
        ep._floored = real


def evidence_and_grads(hb, X, Y, device, dtype, method):
    cfg = hb.settings.get_settings()
    cfg.dtypes.float_type = dtype
    with hb.settings.temp_settings(cfg):
        hb.set_seed(0)
        m = hb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=128, device=device)
        opt = getattr(m, method)().compile(learning_rate=0.05)
        val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, opt._data_args(),
                                        m.generator, None)
        val.backward()
        return val.item(), {k: float(t.grad.reshape(-1)[0]) for k, t in opt._trainable.items()}


def trajectory(hb, X, Y, device, steps=100):
    hb.set_seed(0)
    m = hb.models.SparseGPC(seed=0, X=X, Y=Y, num_inducing=128, device=device)
    opt = m.log_marginal_ep().compile(learning_rate=0.05)
    t0 = time.perf_counter()
    opt.optimize(maxiter=steps)
    h = np.concatenate(opt.history) / len(X)
    return (h[:10].mean(), h[-10:].mean(), float(m.k_var.value[0]),
            float(m.gp.kern.lengthscales.value[0]), opt.metrics.rows[-1]["ep_delta"],
            time.perf_counter() - t0)


def main():
    import henbun_tpu_torch as hb

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0))
    X, Y = sparse_gpc_data(args.n)
    lap = evidence_and_grads(hb, X, Y, args.device, torch.float64, "log_marginal_laplace")
    print("laplace float64 evidence %.6f grads %s" % (lap[0], lap[1]))
    for name, (base, stopped) in FLOORS.items():
        with floor(base, stopped):
            for dtype in (torch.float64, torch.float32):
                v, g = evidence_and_grads(hb, X, Y, args.device, dtype, "log_marginal_ep")
                print("%s %s ep evidence %.6f grads %s" % (name, str(dtype)[6:], v, " ".join(
                    "%s=%.7g" % kv for kv in sorted(g.items()))))
            print("%s train float32: per-row evidence first10 %.6f last10 %.6f k_var %.4f "
                  "lengthscale %.4f ep_delta %.3g (%.1f s)"
                  % ((name,) + trajectory(hb, X, Y, args.device)), flush=True)


if __name__ == "__main__":
    main()
