"""SMC on a tomographic-reconstruction-style inverse problem, BASELINE.json
config 5: particles split over the mesh's 'chain' dimension when the
``torch.distributed`` world has more than one rank (the twin of
``examples/smc_tomography.py``).

Unknown: a coarse 2D absorption image with a Gaussian smoothness prior.
Data: noisy line-integral projections (Radon-style rows/columns/diagonals).
The model is linear-Gaussian, so the SMC posterior mean can be validated
against the analytic posterior.

Run: python -m henbun_tpu_torch.examples.smc_tomography [--grid 8]
[--particles 4096] [--device cpu]. It runs on the card unless
``--device cpu``.
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from henbun_tpu_torch.inference import smc
from henbun_tpu_torch.parallel import make_mesh


def projection_matrix(g):
    """Row, column and two diagonal-band line integrals over a g x g grid."""
    rows = []
    idx = np.arange(g * g).reshape(g, g)
    for i in range(g):
        r = np.zeros(g * g); r[idx[i, :]] = 1.0; rows.append(r)
        c = np.zeros(g * g); c[idx[:, i]] = 1.0; rows.append(c)
    for off in range(-g + 1, g):
        d = np.zeros(g * g); d[np.diag(idx, off)] = 1.0; rows.append(d)
    return np.stack(rows).astype(np.float32)


def smoothness_precision(g, strength=4.0):
    """Graph-Laplacian precision + ridge: neighboring pixels correlate."""
    n = g * g
    L = np.zeros((n, n))
    idx = np.arange(n).reshape(g, g)
    for i in range(g):
        for j in range(g):
            a = idx[i, j]
            for di, dj in [(0, 1), (1, 0)]:
                if i + di < g and j + dj < g:
                    b = idx[i + di, j + dj]
                    L[a, a] += 1; L[b, b] += 1; L[a, b] -= 1; L[b, a] -= 1
    return (strength * L + np.eye(n)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=8)
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = args.grid
    rng = np.random.default_rng(0)
    # ground-truth image: a smooth blob
    xv, yv = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g))
    truth = np.exp(-((xv - 0.2) ** 2 + (yv + 0.1) ** 2) / 0.3).ravel().astype(np.float32)

    A = projection_matrix(g)
    y = A @ truth + rng.normal(size=A.shape[0]).astype(np.float32) * args.noise
    P0 = smoothness_precision(g)
    noise_var = args.noise**2

    # analytic posterior (linear-Gaussian)
    post_prec = P0 + A.T @ A / noise_var
    post_mean = np.linalg.solve(post_prec, A.T @ y / noise_var)

    At, yt, P0t = (torch.as_tensor(a, device=dev) for a in (A, y, P0))

    def log_prior(t):
        return -0.5 * t @ P0t @ t

    def log_lik(t):
        r = At @ t - yt
        return -0.5 * torch.sum(r**2) / noise_var

    # prior samples via the prior precision's Cholesky
    Lp = np.linalg.cholesky(np.linalg.inv(P0))
    z = rng.normal(size=(args.particles, g * g)).astype(np.float32)
    particles = torch.as_tensor(z @ Lp.T, device=dev)

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(n_data=1, n_chain=n_dev, device_type=dev.type) if n_dev > 1 else None
    res = smc.sample(
        log_prior, log_lik, particles, torch.Generator(device=dev).manual_seed(1),
        num_move_steps=5, num_leapfrog=8, step_size=0.05, mesh=mesh,
    )
    est = res.particles.mean(0).cpu().numpy()
    print("stages:", int(res.num_stages), " final beta:", float(res.final_beta))
    print("log evidence:", float(res.log_evidence))
    print("posterior-mean error vs analytic: %.4f" % np.abs(est - post_mean).mean())
    print("reconstruction RMSE vs truth: %.4f" % np.sqrt(np.mean((est - truth) ** 2)))


if __name__ == "__main__":
    main()
