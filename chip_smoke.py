#!/usr/bin/env python3
"""Drive henbun_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. card: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles every kernel source (csrc/*.cu) with nvcc for sm_90a,
   one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the listed shapes (NaN isolation, NaN in the unread triangle), with the
   kernel's, the plain version's and one torch.linalg call's times;
4. path: trains the 16-model GPR fleet (GaussianProcess.ipynb, n = 40,
   fullrank q, Adam 0.01) through BatchedOptimizer for 2,000 steps in
   chunks of 200, counting kernel launches; then holds 20 steps against
   the same fleet with use_kernels off under the same injected noise, and
   the fleet's objective on the card against the CPU's;
5. profile: a traced window of 50 fleet steps (device time by kernel,
   the card's busy share, host self time by op);
6. single model: the same GPR alone for 300 steps (torch.linalg path).

Prints a line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

FLEET = 16
N = 40
STEPS = 2000
CHUNK = 200
CHECK_STEPS = 20
PROFILE_STEPS = 50
SINGLE_STEPS = 300
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-4         # kernel vs plain on O(1) factors: float32, FMA vs mul+sub


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean milliseconds per call on the card (CUDA events around `iters`
    back-to-back calls, after `warmup`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(ms, what bounds it): the least time the card could take, bytes over
    the HBM rate or float32 operations over the float32 peak, whichever is
    larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chol_cost(B, n):
    """Bytes (lower triangle read once, factor written once) and operations
    (n square roots, the column divides, a multiply and a subtract per
    trailing update) of B factorizations."""
    nbytes = B * (n * (n + 1) // 2 + n * n) * 4
    flops = B * (n + n * (n - 1) // 2 + (n - 1) * n * (n + 1) // 3)
    return nbytes, flops


def solve_cost(B, n, m):
    """Bytes (L's lower triangle, the right-hand side, the solution) and
    operations (n^2 per column) of B solves."""
    nbytes = B * (n * (n + 1) // 2 + 2 * n * m) * 4
    return nbytes, B * m * n * n


def spd(torch, B, n, seed, device):
    """SPD batch, eigenvalues log-spaced in [0.01, 1], from a numpy seed."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    A = (Q * np.logspace(-2, 0, n)) @ np.swapaxes(Q, -1, -2)
    return torch.tensor(A.astype(np.float32), device=device)


def lower(torch, B, n, seed, device):
    """Lower factors with unit-order diagonals and NaN above the diagonal."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(B, n, n)) * (0.5 / np.sqrt(n)))
    L[:, np.arange(n), np.arange(n)] = rng.uniform(1.0, 2.0, size=(B, n))
    iu = np.triu_indices(n, 1)
    L[:, iu[0], iu[1]] = np.nan
    return torch.tensor(L.astype(np.float32), device=device)


def max_err(torch, got, want):
    """Largest |got - want| where want is finite; NaN must match NaN."""
    check(bool(torch.equal(torch.isnan(got), torch.isnan(want))), "NaN pattern differs")
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if finite.any() else 0.0


def kernel_phase(torch, hb):
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    dev = "cuda"
    errs = {"K1": 0.0, "K2": 0.0}
    times = {}
    for B, n in ((16, N), (16, 128), (96, 128), (3, 7)):
        A = spd(torch, B, n, seed=B * 1000 + n, device=dev)
        L = cuda_chol.cholesky128_vbatched(A)
        torch.cuda.synchronize()
        err = max_err(torch, L, cuda_chol.cholesky128_plain(A))
        check(err <= KERNEL_ATOL, "K1 B=%d n=%d: max error %g" % (B, n, err))
        check(bool((torch.triu(L, 1) == 0).all()), "K1 wrote above the diagonal")
        errs["K1"] = max(errs["K1"], err)
        row = {
            "ms": time_ms(torch, lambda: cuda_chol.cholesky128_vbatched(A)),
            "plain_ms": time_ms(torch, lambda: cuda_chol.cholesky128_plain(A), iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.linalg.cholesky_ex(A)),
        }
        times[("K1", B, n)] = row
        print("K1 cholesky B=%d n=%d max_abs_err=%.3g kernel_ms=%.4f plain_ms=%.4f "
              "library_ms=%.4f" % (B, n, err, row["ms"], row["plain_ms"], row["library_ms"]))
    # NaN isolation: one non-SPD matrix in the batch; the upper triangle,
    # which the kernel must not read, holds NaN too
    A = spd(torch, FLEET, N, seed=5, device=dev)
    A[3] = -A[3]
    iu = torch.triu_indices(N, N, 1, device=dev)
    A[:, iu[0], iu[1]] = float("nan")
    L = cuda_chol.cholesky128_vbatched(A)
    torch.cuda.synchronize()
    check(bool(torch.isnan(L[3]).all()), "K1: the non-SPD matrix is not all NaN")
    others = torch.cat([L[:3], L[4:]])
    check(bool(torch.isfinite(others).all()), "K1: NaN leaked into other matrices")
    err = max_err(torch, L, cuda_chol.cholesky128_plain(A))
    check(err <= KERNEL_ATOL, "K1 NaN isolation: max error %g" % err)
    errs["K1"] = max(errs["K1"], err)
    print("K1 cholesky NaN isolation B=%d n=%d ok max_abs_err=%.3g" % (FLEET, N, err))

    for B, n, m in ((16, N, N), (16, N, 1), (16, 128, 128)):
        Lf = lower(torch, B, n, seed=n * 7 + m, device=dev)
        R = torch.tensor(np.random.default_rng(m).normal(size=(B, n, m)).astype(np.float32),
                         device=dev)
        for transpose in (False, True):
            X = cuda_solve.tri_solve128_vbatched(Lf, R, transpose)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(X).all()), "K2 read the NaN triangle")
            err = max_err(torch, X, cuda_solve.tri_solve128_plain(Lf, R, transpose))
            check(err <= KERNEL_ATOL, "K2 B=%d n=%d m=%d T=%s: max error %g"
                  % (B, n, m, transpose, err))
            errs["K2"] = max(errs["K2"], err)
            Lt = torch.tril(torch.nan_to_num(Lf))
            row = {
                "ms": time_ms(torch, lambda: cuda_solve.tri_solve128_vbatched(Lf, R, transpose)),
                "plain_ms": time_ms(
                    torch, lambda: cuda_solve.tri_solve128_plain(Lf, R, transpose), iters=5, warmup=1
                ),
                "library_ms": time_ms(
                    torch,
                    lambda: torch.linalg.solve_triangular(
                        Lt.mT if transpose else Lt, R, upper=transpose
                    ),
                ),
            }
            times[("K2", B, n, m, transpose)] = row
            print("K2 tri_solve B=%d n=%d m=%d transpose=%s max_abs_err=%.3g kernel_ms=%.4f "
                  "plain_ms=%.4f library_ms=%.4f"
                  % (B, n, m, transpose, err, row["ms"], row["plain_ms"], row["library_ms"]))
    return errs, times


def make_fleet(hb, device):
    hb.set_seed(0)
    models = []
    for i in range(FLEET):
        X, Y = hb.models.make_sine_dataset(n=N, seed=i)
        models.append(hb.models.GPR(seed=i, X=X, Y=Y, device=device))
    return hb.BatchedOptimizer(models, "ELBO_gaussian").compile(learning_rate=0.01)


def settings_with(hb, **cuda):
    cfg = hb.settings.get_settings()
    for k, v in cuda.items():
        setattr(cfg.cuda, k, v)
    return cfg


def path_phase(torch, hb):
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    counters = (cuda_chol.cholesky128_vbatched, cuda_solve.tri_solve128_vbatched)
    bo = make_fleet(hb, "cuda")
    with hb.settings.temp_settings(settings_with(hb, scan_chunk=CHUNK)):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bo.optimize(maxiter=STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"K1": counters[0].launches, "K2": counters[1].launches}
    hist = np.concatenate(bo.history)
    check(hist.shape == (STEPS,) and np.isfinite(hist).all(), "fleet objective not finite")
    first, last = float(np.mean(bo.history[0])), float(np.mean(bo.history[-1]))
    check(last > first, "fleet objective did not rise (%g -> %g)" % (first, last))
    check(launches["K1"] >= STEPS, "K1 launched %d times in %d steps" % (launches["K1"], STEPS))
    check(launches["K2"] >= 2 * STEPS, "K2 launched %d times in %d steps" % (launches["K2"], STEPS))
    k_var = np.array([m.k_var.value[0] for m in bo.models])
    check(np.isfinite(k_var).all(), "fitted k_var not finite")
    steps_per_s = STEPS / seconds
    print("path: fleet=%d n=%d steps=%d chunk=%d seconds=%.3f steps_per_s=%.1f "
          "last_chunk_steps_per_s=%.1f objective first_chunk_mean=%.2f last_chunk_mean=%.2f "
          "launches K1=%d K2=%d per_step K1=%.3f K2=%.3f"
          % (FLEET, N, STEPS, CHUNK, seconds, steps_per_s, bo.metrics.rows[-1]["steps_per_s"],
             first, last, launches["K1"], launches["K2"],
             launches["K1"] / STEPS, launches["K2"] / STEPS))
    return launches, steps_per_s


def agreement_phase(torch, hb):
    """20 steps with the kernels against 20 with use_kernels off, the same
    fleet and injected noise (rtol 1e-4 of the objective's scale); and the
    fleet's objective on the card against the CPU's (plain versions) under
    the same noise and weights (rtol 1e-4)."""
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    noise = [torch.randn(FLEET, N, generator=g, device="cuda") for _ in range(CHECK_STEPS)]
    runs = {}
    for use_kernels in (True, False):
        bo = make_fleet(hb, "cuda")
        bo.noise_source = lambda step: {"q": noise[step]}
        with hb.settings.temp_settings(
            settings_with(hb, scan_chunk=CHECK_STEPS, use_kernels=use_kernels)
        ):
            before = (cuda_chol.cholesky128_vbatched.launches,
                      cuda_solve.tri_solve128_vbatched.launches)
            bo.optimize(maxiter=CHECK_STEPS)
            after = (cuda_chol.cholesky128_vbatched.launches,
                     cuda_solve.tri_solve128_vbatched.launches)
        if not use_kernels:
            check(after == before, "use_kernels off still launched the kernels")
        runs[use_kernels] = bo.history[-1]
    # rtol 1e-4 against the objective's scale over the 20 steps, not each
    # step's own value: two correct float32 paths drift apart under Adam
    # (its normalized steps turn tiny gradient differences into parameter
    # differences), and where the noisy objective dips, that drift alone
    # can pass 1e-4 of the step's value
    diff = np.abs(runs[True] - runs[False])
    rel = float(diff.max() / np.abs(runs[False]).max())
    per_step = diff / np.abs(runs[False])
    check(rel <= 1e-4, "kernel vs use_kernels=False: objective differs by %g of its scale" % rel)
    print("agreement: %d steps kernels vs use_kernels=False max_diff/scale=%.3g "
          "per_step_max_rel=%.3g at step %d (step 0: %.3g)"
          % (CHECK_STEPS, rel, per_step.max(), int(per_step.argmax()), per_step[0]))

    on_card = make_fleet(hb, "cuda")
    params = {k: v.detach().cpu() for k, v in on_card._trainable.items()}
    hb.set_seed(0)
    cpu_models = [hb.models.GPR(seed=i, X=m.X.value, Y=m.Y.value, device="cpu")
                  for i, m in enumerate(on_card.models)]
    for i, m in enumerate(cpu_models):
        m.set_param_dict({k: v[i] for k, v in params.items()})
    on_cpu = hb.BatchedOptimizer(cpu_models, "ELBO_gaussian").compile(learning_rate=0.01)
    v_card = float(on_card.run(noise={"q": noise[0]}))
    v_cpu = float(on_cpu.run(noise={"q": noise[0].cpu()}))
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    check(rel <= 1e-4, "fleet objective card %g vs CPU %g" % (v_card, v_cpu))
    print("reference: fleet objective card=%.6f cpu=%.6f rel_diff=%.3g" % (v_card, v_cpu, rel))


def profile_phase(torch, hb):
    """A traced window of fleet steps: device time by kernel and the share
    of the window the card was busy (torch.profiler, CPU and CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    bo = make_fleet(hb, "cuda")
    with hb.settings.temp_settings(settings_with(hb, scan_chunk=PROFILE_STEPS)):
        bo.optimize(maxiter=PROFILE_STEPS)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bo.optimize(maxiter=PROFILE_STEPS)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    # device activity only: kernels, copies and sets, not the ranges that
    # record_function annotations project onto the device timeline
    events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print("profile: fleet %d steps wall_ms=%.3f device_busy_ms=%.3f busy_share=%.4f "
          "device_ops=%d per_step=%.1f"
          % (PROFILE_STEPS, wall_ms, busy_ms, busy_ms / wall_ms, len(events),
             len(events) / PROFILE_STEPS))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print("  device %.3f ms (%.1f%% of busy) %s" % (ms, 100 * ms / max(busy_ms, 1e-9), name[:90]))
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    for a in host:
        print("  host self %.3f ms x%d %s" % (a.self_cpu_time_total / 1e3, a.count, a.key[:70]))


def single_phase(torch, hb):
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    hb.set_seed(0)
    X, Y = hb.models.make_sine_dataset(n=N, seed=0)
    opt = hb.models.GPR(seed=0, X=X, Y=Y).ELBO_gaussian().compile(learning_rate=0.01)
    before = (cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches)
    t0 = time.perf_counter()
    with hb.settings.temp_settings(settings_with(hb, scan_chunk=SINGLE_STEPS)):
        opt.optimize(maxiter=SINGLE_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = (cuda_chol.cholesky128_vbatched.launches, cuda_solve.tri_solve128_vbatched.launches)
    hist = opt.history[-1]
    check(np.isfinite(hist).all(), "single-model objective not finite")
    check(after == before, "the single-model path (2-D) reached a batched kernel")
    print("single: n=%d steps=%d steps_per_s=%.1f objective first=%.2f last=%.2f device=%s"
          % (N, SINGLE_STEPS, SINGLE_STEPS / seconds, hist[0], hist[-1], opt.device))


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed: " + smi.stderr)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "henbun_tpu_torch")):
        fail("henbun_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, here)
    import henbun_tpu_torch as hb
    from henbun_tpu_torch.ops import _build

    print("torch %s cuda %s python %s" % (torch.__version__, torch.version.cuda,
                                          sys.version.split()[0]))
    t0 = time.perf_counter()
    logs = _build.build_all()
    print("build: %s in %.1f s" % (", ".join(sorted(logs)), time.perf_counter() - t0))
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print("  %s: %s" % (name, line.strip()))

    errs, times = kernel_phase(torch, hb)
    launches, steps_per_s = path_phase(torch, hb)
    agreement_phase(torch, hb)
    profile_phase(torch, hb)
    single_phase(torch, hb)

    k1 = times[("K1", FLEET, N)]
    k2 = times[("K2", FLEET, N, N, True)]
    kernels = []
    for name, src, replaces, key, row, cost in (
        ("cholesky128_vbatched", "chol128.cu", "pallas_chol.py:140", "K1", k1,
         chol_cost(FLEET, N)),
        ("tri_solve128_vbatched", "trisolve128.cu", "pallas_solve.py:140", "K2", k2,
         solve_cost(FLEET, N, N)),
    ):
        bound_ms, bound_by = bound(*cost)
        kernels.append(dict(
            name=name, route="cuda", source="henbun_tpu_torch/csrc/" + src,
            replaces="henbun_tpu/ops/" + replaces, launches=launches[key],
            max_abs_err=errs[key], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=row["library_ms"],
        ))
    print("timed at the path's shapes: K1 B=%d n=%d; K2 B=%d n=m=%d transpose=True; "
          "fleet steps_per_s=%.1f" % (FLEET, N, FLEET, N, steps_per_s))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
