"""The port's entry points, the twins of the JAX package's
``__graft_entry__.py``.

* :func:`entry` returns ``(fn, example_args)``: ``fn(params, noise)``
  evaluates the ELBO of the amortized-SVI flagship (encoder -> local q ->
  decoder -> ELBO) at n = 256, d_x = 4, d_z = 2, hidden 16.
* :func:`dryrun_multichip` starts n ranks and runs SIX sharded mechanisms
  on tiny shapes, one step or one short run each: data-sharded SVI, a
  model-sharded GPR fleet, the sparse-Laplace and projected-EP evidence
  (their full-batch rows split over ``data``, ``parallel/rows.py``),
  chain-sharded ChEES and particle-sharded SMC.

Both run on the ``[cuda] device`` setting's device (the card) unless
``device="cpu"`` asks otherwise; without a card they raise, as a Model
does (``_settings.resolve_device``). From a shell
(the ranks of a dry run are processes of this module)::

    python -m henbun_tpu_torch.entry [n] [--device cpu|cuda]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ._settings import resolve_device


def _tiny_model(device=None):
    import henbun_tpu_torch as hb

    hb.set_seed(0)
    X, Y = hb.models.make_synthetic_regression(n=256, d_x=4)
    return hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=2, hidden=16, device=device)


def entry(device=None):
    """Returns (fn, example_args): fn(params, noise) -> the ELBO scalar of
    the amortized-SVI flagship at ``params`` (the model's whole
    ``{path: tensor}`` dict, trainable and frozen), with ``noise``
    ({path: u}) injected, or drawn from the model's generator when None."""
    from henbun_tpu_torch import models
    from henbun_tpu_torch.core import context as _ctx

    m = _tiny_model(resolve_device(device))
    m.initialize()
    data = m._gather_data()

    def elbo_step(params, noise=None):
        with _ctx.trace(m, params, data, m.generator, noise=noise):
            return models.AmortizedRegression.ELBO.__wrapped__(m)

    return elbo_step, (m.param_dict(), None)


def _finite(hist):
    h = np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in hist])
    if not np.isfinite(h).all():
        raise FloatingPointError("non-finite objective %r" % (h,))
    return h.tolist()


def _mechanisms(n, device):
    """The six mechanisms on this rank; returns what each produced."""
    import henbun_tpu_torch as hb
    from henbun_tpu_torch.inference import chees, smc
    from henbun_tpu_torch.parallel import ShardedBatchedOptimizer, ShardedOptimizer, make_mesh

    out = {}
    # split the ranks between data and chain when possible, to exercise
    # both mesh dimensions
    n_chain = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n_data=n // n_chain, n_chain=n_chain, device_type=device.type)

    opt = ShardedOptimizer(_tiny_model(device), "ELBO", mesh=mesh)
    opt.compile(hb.adam(0.005)).optimize(maxiter=1, minibatch_size=32)
    out["svi"] = _finite(opt.history)

    # model-parallel: n independent fits over 'chain'
    mesh2 = make_mesh(n_data=1, n_chain=n, device_type=device.type)
    fleet = []
    for i in range(n):
        X, Y = hb.models.make_sine_dataset(n=16, seed=i)
        fleet.append(hb.models.GPR(seed=i, X=X, Y=Y, device=device))
    bo = ShardedBatchedOptimizer(fleet, "ELBO_gaussian", mesh=mesh2)
    bo.compile(hb.adam(0.01)).optimize(maxiter=1)
    out["fleet"] = _finite(bo.history)

    # the deterministic evidence engines: the full batch's rows split over
    # 'data', the m x m algebra replicated
    rng = np.random.default_rng(0)
    Xc = np.sort(rng.uniform(0, 6, (16 * n, 1))).astype(np.float32)
    Yc = (rng.uniform(size=Xc.shape) < 0.5).astype(np.float32)
    mc = hb.models.SparseGPC(seed=0, X=Xc, Y=Yc, num_inducing=8, newton_iters=4, device=device)
    for name in ("log_marginal_laplace", "log_marginal_ep"):
        oc = ShardedOptimizer(mc, name, mesh=mesh)
        oc.compile(hb.adam(0.05)).optimize(maxiter=1)
        out[name] = {"hist": _finite(oc.history),
                     "rows": list(oc._row_block or (0, len(Xc)))}

    # chain-sharded ChEES: the cross-chain criterion's mean is the one
    # collective
    g = torch.Generator(device=device)
    g.manual_seed(2)
    res = chees.sample(lambda t: -0.5 * torch.sum(t * t),
                       torch.randn(2 * n, 3, generator=g, device=device), 3,
                       num_samples=8, num_warmup=8, mesh=mesh2)
    out["chees"] = {"mean": float(np.mean(_finite([res.samples.cpu()]))),
                    "step_size": float(res.step_size)}

    # particle-sharded SMC: a short tempering run over 'chain'
    res = smc.sample(lambda t: -0.5 * torch.sum(t * t),
                     lambda t: -0.5 * torch.sum(torch.square(t - 1.0)),
                     torch.randn(16 * n, 4, generator=g, device=device), 1,
                     num_move_steps=1, num_leapfrog=2, max_stages=3, mesh=mesh2)
    out["smc"] = {"log_evidence": _finite([res.log_evidence.cpu()])[0],
                  "stages": int(res.num_stages)}
    return out


def _rank_main(rank, n, directory, device_type):
    """One rank of :func:`dryrun_multichip`: NCCL between cards, gloo on
    the CPU or where ranks share a card; its results go to
    ``<directory>/rank<r>.json``."""
    import torch.distributed as dist

    resolve_device(device_type)  # a missing card raises, as for a Model
    if device_type == "cuda":
        nccl = n <= torch.cuda.device_count()
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        nccl, device = False, torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method="file://" + os.path.join(directory, "store"),
                            world_size=n, rank=rank)
    try:
        out = _mechanisms(n, device)
        out.update(backend=dist.get_backend(), device=str(device))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(directory, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)


def _wait(procs, timeout):
    """Wait for every process; the index of the first that failed (or is
    still running at `timeout`), else None."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return bad[0]
        if all(c == 0 for c in codes):
            return None
        time.sleep(0.05)
    return next(i for i, p in enumerate(procs) if p.poll() is None)


def dryrun_multichip(n_devices, device=None, timeout=600):
    """Run the six sharded mechanisms on ``n_devices`` ranks, each a
    process of this module: gloo on the CPU; on cards, NCCL where there
    are as many cards as ranks, else gloo with the ranks sharing the
    cards. `device` defaults to the ``[cuda] device`` setting's, which
    raises here without a card; a device named by the caller is each
    rank's to resolve, so a rank asked for a missing card fails. Raises if
    a rank fails. Returns each rank's results."""
    device = torch.device(device) if device is not None else resolve_device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="henbun_dryrun_") as d:
        logs = [os.path.join(d, "rank%d.log" % r) for r in range(n_devices)]
        procs = []
        try:
            for r in range(n_devices):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "henbun_tpu_torch.entry", "--rank", str(r),
                         str(n_devices), d, device.type],
                        env=env, stdout=log, stderr=subprocess.STDOUT))
            failed = _wait(procs, timeout)
        finally:
            for p in procs:  # a rank that failed leaves the others in a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed is not None:
            with open(logs[failed]) as log:
                raise RuntimeError("dryrun_multichip: rank %d of %d failed (exit %s):\n%s"
                                   % (failed, n_devices, procs[failed].returncode,
                                      log.read()[-4000:]))
        out = []
        for r in range(n_devices):
            with open(os.path.join(d, "rank%d.json" % r)) as f:
                out.append(json.load(f))
    return out


def main(argv):
    if argv[:1] == ["--rank"]:
        _rank_main(int(argv[1]), int(argv[2]), argv[3], argv[4])
        return
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    n = int(argv[0]) if argv else 2
    fn, args = entry(device)
    print("entry ELBO:", float(fn(*args)))
    for r, res in enumerate(dryrun_multichip(n, device)):
        print("rank %d (%s, %s): %s" % (r, res["backend"], res["device"], json.dumps(
            {k: v for k, v in res.items() if k not in ("backend", "device")})))
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main(sys.argv[1:])
