"""HMC, NUTS or ChEES over BNN weights, BASELINE.json config 4: 256 chains,
split over the mesh's 'chain' dimension when the ``torch.distributed``
world has more than one rank (the twin of ``examples/hmc_bnn.py``).

Run: python -m henbun_tpu_torch.examples.hmc_bnn [--sampler nuts]
[--chains 256] [--device cpu]. It runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

import henbun_tpu_torch as hb
from henbun_tpu_torch import models
from henbun_tpu_torch.inference import make_log_prob, hmc, nuts, chees
from henbun_tpu_torch.parallel import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", choices=["hmc", "nuts", "chees"], default="chees")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    hb.set_seed(0)
    X, Y = models.make_bnn_dataset(n=128)
    m = models.BNN(seed=0, X=X, Y=Y, hidden=16, device=dev)
    flp = make_log_prob(m, "log_posterior")
    print("dim:", flp.dim)

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(n_data=1, n_chain=n_dev, device_type=dev.type) if n_dev > 1 else None
    g_init = torch.Generator(device=dev).manual_seed(0)
    init = flp.initial + 0.1 * torch.randn(
        (args.chains, flp.dim), generator=g_init, dtype=flp.initial.dtype, device=dev
    )

    sampler = {"hmc": hmc, "nuts": nuts, "chees": chees}[args.sampler]
    res = sampler.sample(
        flp.log_prob, init, torch.Generator(device=dev).manual_seed(1),
        num_samples=args.samples, num_warmup=args.warmup, mesh=mesh,
    )
    samples = res.samples.cpu().numpy()
    ess = hmc.effective_sample_size(samples)
    print("accept: %.3f" % float(res.accept_prob.mean()))
    print("ESS (min/median/max): %.0f / %.0f / %.0f" % (
        ess.min(), np.median(ess), ess.max()))

    # posterior predictive through the model tree
    mean_theta = torch.as_tensor(samples.reshape(-1, flp.dim).mean(0))
    flp.set_model_state(mean_theta)
    pred = m.run(lambda mm: mm.net(mm.x)).cpu().numpy()
    print("posterior-mean-weights RMSE:", float(np.sqrt(np.mean((pred - Y) ** 2))))


if __name__ == "__main__":
    main()
