#!/usr/bin/env python3
"""Drive henbun_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. card: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles every kernel source (csrc/*.cu) with nvcc for sm_90a,
   one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the listed shapes, among them those the GPR, Laplace (n = 40) and GPC
   (n = 60) fleets give it (NaN isolation, a pivot failing past the first
   panels at n = 128, NaN in the unread triangle), with the kernel's, the
   plain version's and (where one exists) one library call's times: the
   wall time per call (CUDA events around back-to-back calls, which at
   small shapes is the host's dispatch floor) and the device time per
   call (torch.profiler, device_ms);
4. GPR path: trains the 16-model GPR fleet (GaussianProcess.ipynb, n = 40,
   fullrank q, Adam 0.01) through BatchedOptimizer for 500 steps in
   chunks of 200, counting kernel launches; then holds 20 steps against
   the same fleet with use_kernels off under the same injected noise, and
   the fleet's objective on the card against the CPU's;
5. Laplace path: trains 16 robust GPRs on their Laplace evidence
   (log_marginal_laplace_student, benchmarks/laplace_bench.py's data,
   n = 40, Adam 0.02) for 250 steps in chunks of 200, counting K1, K2
   and K3 launches, and 16 GPCs (log_marginal_laplace, n = 60, Adam 0.05)
   for 100 steps; each fit's grad_norm must end below 1. Then, for both
   fleets, 20 steps with the kernels against 20 with use_kernels off and
   the evidence on the card against the CPU's; and the Laplace fleet's
   steps/s with the kernels on and off;
6. profile: traced windows of the GPR fleet and the Laplace fleet (device
   time by kernel, the card's busy share, device operations a step);
7. single model: the same GPR alone for 300 steps (torch.linalg path);
8. blocked: ops/blocked.py's Cholesky and triangular solves (both
   transposes, m = n right-hand sides) at n = 2048 and 4096 against
   torch.linalg, error and times; and at the blocked panel widths, the
   K2-chunked diagonal solve the blocked loop runs against K6;
9. exact-gram path: GPRMarginal at n = 4096 (sorted U[0, 6] inputs, sine
   targets) trained for 50 Adam steps in one chunk on the card, its
   evidence and gradient at the initial weights against the CPU's,
   predict_f at 1,000 new points, a traced window of 10 steps, and the
   evidence step with safe_cholesky's Murray backward against
   torch.linalg.cholesky's native gradient.

10. amortized path (BASELINE config 3's width): AmortizedRegression
   (d_z = 4, hidden = 64) on 1e6 synthetic rows kept on the card, Adam
   0.003, minibatches of 1,024: 500 steps with diagonal locals, 300 with
   fullrank_packed ones; the ELBO card vs CPU at the same weights, rows
   and noise; a traced window each;
11. SVGP path (benchmarks/svgp_bench.py's width: n = 1e6, m = 128,
   minibatch 1,024, block mode): 150 steps each of the MC ELBO with Adam,
   the analytic ELBO with natural_gradient(1.0) and the classification
   quadrature ELBO with natural_gradient(0.1), K1 and K2 launches a step
   counted; for the natural-gradient pairings 20 steps with the kernels
   and 20 without, and one update on the card and on the CPU, each held
   to float64 (natgrad_checks);
12. natgrad fleet: 16 GPRs on ELBO_student_quadrature with
   natural_gradient(0.2) (n = 40, the Laplace fleet's data), 200 steps,
   launches counted, 20 steps kernels on vs off;
13. EP fleets: 16 robust GPRs on log_marginal_ep_student (n = 40, Adam
   0.02, 40 steps) and 16 GPCs on log_marginal_ep (n = 60, Adam 0.05,
   40 steps): K1 and K2 launches and host reads a step, ep_delta, 20
   steps kernels on vs off, card vs CPU evidence and gradient, steps/s
   with the kernels on and off;
14. sparse evidence at n = 1e5, m = 128, full batch
   (benchmarks/families_bench.py's rows): SparseGPC Laplace (80 steps)
   and EP (30), SparseGPRobust Laplace (100, 4% gross outliers) and
   unrolled EP (8), SparseGPC with train_z (30); card vs CPU at the
   initial weights, the JAX tests' accuracy gates, steps/s, host reads a
   step, a traced window, peak memory;
15. sparse fleet: 16 SparseGPCs at n = 96, m = 24 (Laplace, 100 steps),
   K3 once a step, 20 steps kernels on vs off;
16. resume: save_state after 50 steps of phase 14's SparseGPC Laplace run,
   restore_state into a fresh optimizer, 20 steps each way;
17. multiclass (benchmarks/multiclass_scale_bench.py): SparseGPMulticlass at
   n = 1e5, m = 128, K = 3, full batch, Adam 0.05, 100 steps; the evidence
   and gradient card vs CPU at the initial weights (each gradient leaf
   held to the card's float64), the CholQR2 logdet and
   an H-solve against float64, the grid probabilities against the
   generator, steps/s, host reads, a traced window, peak memory; with
   k_var = 100 whether CholQR2's first pass goes indefinite at shift 1e-4
   and 1e-6 (measured, not gated);
18. samplers (BASELINE config 4, benchmarks/ess_bench.py): HMC, ChEES and
   NUTS on BNN(hidden=16), 49 dimensions, 256 chains, 200 + 200
   iterations (ChEES 100 + 100, NUTS 30 + 30): bulk ESS/s, accept, leapfrogs, device operations and host
   reads an iteration; each sampler on a 50-dim correlated Gaussian, its
   means and covariance held to the JAX tests' limits and to 6 of this
   run's Monte Carlo standard errors;
19. Bayesian hyperparameters (examples/bayes_hypers_sparse.py): ChEES over
   SparseGPC.log_posterior at n = 2e4, m = 32, 8 chains, 50 + 50 draws
   through sample_posterior; K1 and K2 launches a gradient evaluation and
   an iteration, the vmapped log_prob and gradient card vs CPU and kernels
   on vs off, each gradient leaf held to the card's float64;
20. SMC (BASELINE config 5, benchmarks/smc_bench.py): 8 x 8 tomography,
   8,192 particles, 5 moves of 8 leapfrogs: final beta, the posterior
   mean against the analytic one, stages/s, log-evidence against log Z;
21. Expert GPR (BASELINE config 2, examples/expert_gpr.py at n = 150):
   the ELBO and its gradient card vs CPU under the same injected noise
   (each leaf held to the card's float64 at EXPERT_F64_LIMITS), 3,000
   ELBO_single Adam(0.01) steps with jitter_level 3e-4, 1,000 ELBO
   Adam(0.001) steps, predict_f on 25 points, the fit RMSE of the
   30-draw mean against Y below the JAX example's reading plus 0.05;
22. heteroscedastic (benchmarks/families_bench.py's widths): one
   HeteroscedasticGPR (n = 120, fullrank, ELBO_analytic, Adam 0.02); a
   16-model fleet of them through BatchedOptimizer with K1 and K2
   launches a step (both > 0), 20 steps kernels on vs off and the fleet
   objective card vs CPU; HeteroSVGP at n = 1e5, m = 64, minibatches of
   512, its ELBO card vs CPU on the same rows;
23. multi-output: MultiOutputGPR (n = 80, P = 3, Q = 2) with Adam 0.02 and
   under natural_gradient(0.3, rest=Adam(0.02)) with K1 and K2 launches
   a step and 20 steps kernels on vs off; per-latent kernels' predict_f
   at 100 points through K2 against the library; MultiOutputSVGP at
   n = 1e5, Q = 2, m = 64, minibatches of 512;
24. DeepGPRegression (n = 400, m = 32, minibatches of 128, MC ELBO, Adam
   0.01) and GPLVM (n = 1e4, m = 16, hidden 32, minibatches of 256);
25. streaming (BASELINE config 3's AmortizedRegression): 1e6 rows written
   to a temporary row file, 500 steps through optimize_streaming in
   megabatches of 2^16 rows (50 steps each) and minibatches of 1,024:
   every megabatch row in the train split, the distinct rows read against
   sampling with replacement, each megabatch's device copy against what
   the loader handed out, steps/s against phase 10's in-core rate.
26. serving: the per-latent MultiOutputGPR (n = 80, P = 3, Q = 2) fitted
   as in phase 23, its predict_f exported batch-polymorphic for the CPU
   and the card and saved under chiprun_out/, loaded in a fresh python3
   that imports torch and henbun_tpu_torch.serving only and served at 5,
   64, 100 and 200 points on both programs: each card answer equal to
   the eager predict_f, the CPU program's to the card's, K1 and K2
   launches per request (K2 none at 200 points); the GPRMarginal
   predictor and a 32-draw sampler of GPR.predict_f (fullrank q; the same
   seed, the same draws); the artifact call's ms against the eager one's;
27. parallel: over a one-rank NCCL mesh, ShardedBatchedOptimizer on
   phase 4's fleet for 20 steps against BatchedOptimizer under the same
   noise (1e-6 relative, the same K1/K2 launches) and ShardedOptimizer on
   the amortized path at minibatch 512, steps/s each against the
   unsharded drivers; then two gloo ranks on the one card (spawned as
   `chip_smoke.py --rank r 2 <dir>`), the minibatch amortized fit with
   each rank's rows and noise injected, 10 steps, against the one-process
   run on the union of the rows (1e-5 relative). The row-sharded
   full-batch evidence at phase 14's width (SparseGPC at n = 1e5,
   m = 128, log_marginal_laplace and log_marginal_ep): one process, one
   NCCL rank and the two gloo ranks (50,000 rows each), the objective at
   the initial weights within 1e-5 relative of the one-process card
   run's, each gradient leaf within 1e-4 of its largest entry or held to
   the card's float64 as in phase 14, 10 Adam steps finite and rising
   (EP's ep_delta under 1e-2), the row sums' all-reduces and bytes a step
   and steps/s against one process; phase 17's SparseGPMulticlass
   (n = 1e5, m = 128, K = 3) row-sharded the same three ways: the one
   NCCL rank bit for bit the one-process run, the gloo ranks' objective
   within 1e-5 relative, every gradient leaf held to the card's float64
   at phase 17's limits (MC_F64_LIMITS), 5 Adam steps finite and rising,
   the row all-reduces and bytes a step, steps/s against one process;
   over the NCCL rank the SVGP families of tests/test_parallel.py at its
   widths (SVGPMulticlass ELBO and SVGPCount ELBO_analytic at n = 2048,
   HeteroSVGP and MultiOutputSVGP ELBO_analytic at n = 4096, m = 16,
   minibatches 128/256), 20 steps on injected rows against the unsharded
   Optimizer drawing the same noise (1e-6 relative), and the optimizer's
   all-reduces a step (parallel.sharding.stats: one, parameters + 1
   floats; no row or chain collective); henbun_tpu_torch.entry's
   dryrun_multichip(1) over NCCL and dryrun_multichip(2) over gloo on the
   card. No step count was cut for these (about 60 s more for the
   SparseGPC evidence; the multiclass and the families run 5 and 20 steps, not
   phase 17's 100 or the JAX tests' 400-600); the two ranks and the dry
   runs start with the phase and run beside its in-process parts.
28. examples: in a process of its own (`chip_smoke.py --examples <dir>`),
   started before phase 21 and running beside phases 21-27, its output
   printed after phase 27: the main() of each example twin
   (henbun_tpu_torch/examples, every one but serving_export, which phase
   26 covers) on the card at the JAX example's widths (n, m, models, chains, particles, minibatch and
   grid), its stdout captured: its seconds, its K1, K2 and K3 launches
   and its printed lines. Every printed number finite; the fleet,
   svgp_natgrad and bayes_hypers_sparse twins launch K1 and K2; the
   deterministic lines (gaussian_process's quadrature + natural-gradient
   ELBO, Laplace evidence and Laplace RMSE, linear_models' MAP line,
   gp_classification's exact Laplace and EP evidence) within 1e-3 of the
   JAX example's reading on a CPU at the same arguments; smc_tomography's
   final beta and posterior mean within phase 20's limits. Step counts
   cut (the example's default in brackets): gaussian_process 200
   (20,000), fleet 100 (4,000), amortized_svi 100 (5,000), svgp_natgrad
   200 (2,000), svgp_likelihoods 50 (6,000), linear_models MAP 300
   (3,000) and VI 500 (50,000), gp_classification 20 (500), expert_gpr
   150 ELBO_single (3,000) and one round of 100 (10 x 1,000; phase 21
   keeps the full recipe), heteroscedastic 50 (4,000), multioutput 50
   (20,000), deep_gp 50 (6,000), gplvm 150 (6,000), hmc_bnn 50 + 50
   (500 + 500), bayes_hypers_sparse 20 + 20 (300 + 300); smc_tomography
   at its defaults. The steps an example fixes itself stay (EXAMPLE_ARGV).
Each of phases 21-24 is finite and rising and reports steps/s, host
reads a step and a traced window's busy share; phase 21's main phase
runs 1,000 steps where the example runs 10 x 1,000 (cut for time).

Cut to keep the whole run near 600 s once phases 17-20 came (the step
counts before in brackets; every width is the same): phases 4 and 5 run
500 steps (1,000), the amortized path 1,000 diagonal steps (2,000), the
SVGP pairings 250 steps (500), the EP GPR fleet 100 (200), and the sparse
runs SparseGPC Laplace 100 (200), EP 50 (100), unrolled robust EP 15
(30), train_z 50 (100). Cut again to keep it near 700 s once phases 21-25
came: the EP fleets 60 steps each (GPR 100, GPC 100) and NUTS on the BNN
100 + 100 iterations (200 + 200). Cut again for phase 28: NUTS on the
BNN 50 + 50 (100 + 100) and the Bayesian-hyperparameter ChEES run 50 + 50
(100 + 100; phase 28's bayes_hypers_sparse twin samples the same
posterior). Cut again, with phase 28 moved beside phases 21-27, to keep
the run near 600 s on a host slower than the one it was timed on (1,006
s before): the Laplace fleet 250 steps (500), the GPC fleet 100 (200),
the Laplace fleet's rate runs 20 steps each (100), the amortized path 500
diagonal steps (1,000) and 300 packed (500), the SVGP pairings 150 (250),
the EP fleets 40 each (60), the sparse runs SparseGPC Laplace 80 (100),
EP 30 (50), SparseGPRobust Laplace 100 (200), unrolled robust EP 8 (15),
train_z 30 (50), the multiclass path 100 (200), ChEES on the BNN 100 +
100 (200 + 200) and NUTS 30 + 30 (50 + 50).

The kernel phase also checks K1 and K2 at the natural gradient's shapes
(B = 1 and 3 at n = 128, B = 48 at n = 40; K2 as L X = I), at the
Bayesian-hyperparameter path's (K1 at B = 8, n = 32; K2 at n = 32 against
1 column both ways and 32 transposed) and at slice 9's (K1 at B = 16,
n = 120 and B = 6, n = 80; K2 at [16, 120, 120] transposed, [6, 80, 80]
as L X = I and [2, 80, 100]), and holds K4
and K5 (cholesky128, cholesky128_batched:
K1's kernel through their own entries) and K6 (the wide solves) against
their plain versions; no training path launches them.

Prints a line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FLEET = 16
N = 40
STEPS = 500
CHUNK = 200
CHECK_STEPS = 20
PROFILE_STEPS = 50
SINGLE_STEPS = 300
LAPLACE_STEPS = 250
GPC_N = 60
GPC_STEPS = 100
RATE_STEPS = 20            # Laplace fleet steps/s, kernels on and off
LAPLACE_PROFILE_STEPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-4         # kernel vs plain on O(1) factors: float32, FMA vs mul+sub
PROFILE_TRIES = 6          # device_ms: traces of one window before it gives up
# K3 vs plain on the Newton mode (the tolerances of test_fused_newton.py):
# float32 products and factorizations in another order through 15
# dependent iterations; the Bernoulli mode is flatter
NEWTON_ATOL = {"student_t": 1e-4, "bernoulli_logit": 1e-3}
K4_N = (40, 128)
K5_SHAPES = ((16, 40), (256, 128))  # B = 256 is past the TPU kernel's VMEM cap
# 3968: blocked_cholesky's first panel at n = 4096; K6's tile widths
# (cuda_wide.tile_cols): 16 at 128 and 1024, 32 at 3968, 64 at 8192
WIDE_M = (128, 1024, 3968, 8192)
K3_EDGE = 33  # K3's bordered system: 34 rows, a full panel and a narrow one
BLOCKED_N = (2048, 4096)
# blocked vs torch.linalg, relative to the reference's largest entry:
# float32 sums over up to n terms in another order
BLOCKED_RTOL = 1e-4
MARGINAL_N = 4096
MARGINAL_STEPS = 50
MARGINAL_PROFILE_STEPS = 10
MARGINAL_PREDICT = 1000
BACKWARD_STEPS = 10        # evidence steps timed per turn, Murray vs native
# the natural gradient's K1 / K2 shapes: SVGP q(u) at m = 128 (B = 1, 3
# with the stacked retry ladder) and the natgrad GPR fleet (16 x 40, 48)
NATGRAD_SHAPES = ((1, 128), (3, 128), (3 * FLEET, N))
# amortized SVI at BASELINE config 3's width (examples/amortized_svi.py)
AMORT_N = 1_000_000
AMORT_STEPS = {"diagonal": 500, "fullrank_packed": 300}
MINIBATCH = 1024
SLICE_CHUNK = 500          # steps between host syncs on the new paths
SLICE_PROFILE_STEPS = 20
# SVGP at benchmarks/svgp_bench.py's width
SVGP_N = 1_000_000
SVGP_M = 128
SVGP_STEPS = 150
NATGRAD_FLEET_STEPS = 200
# a float32 path's deviation from float64, kernels against library, at
# most this factor (measured at m = 128: objective 1.44x and 1.56x the
# library path's in 20 steps, one update 0.50x and 1.07x the CPU's)
NATGRAD_F32_FACTOR = 2.0
U32 = 2.0 ** -24           # float32's unit roundoff
# the 60-sweep Student-t EP's gradients: float32 paths land up to 2.3e-4 of
# the leaf from float64 (tests/test_torch_ep.py holds both packages at 5e-4)
STUDENT_EP_F32_TOL = 5e-4
# the sparse families' gradients at n = 1e5, m = 128, as far as float32
# holds them: Kmm + jitter I at the quantile z has condition ~3.8e5
# (sparse_kmm_cond prints it), and float32 rounding through its factor
# reaches the lengthscale gradient; the EP sweeps do not settle in float32
# either (largest site change ~0.02 a sweep, float64's 2e-8), and the
# Student-t ones are unrolled. Measured from float64 at the initial weights
# (CPU / card float32): Laplace lengthscale 1.9e-3 / 5.3e-4 (SparseGPC),
# 7.4e-5 / 3.7e-3 (SparseGPRobust); EP 4.9e-3 / 1.2e-2 (SparseGPC), k_var
# 1.0e-2 / 3.7e-2 (SparseGPRobust, unrolled). The bounds sit ~3x above
# the largest
SPARSE_LAPLACE_F32_TOL = 1e-2
SPARSE_EP_F32_TOL = 1e-1
# EP fleets (benchmarks/laplace_bench.py --engine ep, tests/test_ep.py:208)
EP_GPR_STEPS = 40
EP_GPC_STEPS = 40
EP_PROFILE_STEPS = 2       # a traced EP fleet step holds 3,000-7,000 device operations
READ_STEPS = 3             # steps counted under torch.cuda's sync debug mode
# sparse evidence at families_bench.py's width
SPARSE_N = 100_000
SPARSE_M = 128
SPARSE_PROFILE_STEPS = 10
UNROLLED_PROFILE_STEPS = 2  # an unrolled robust EP step holds ~17,600 device operations
SPARSE_FLEET_N = 96
SPARSE_FLEET_M = 24
SPARSE_FLEET_STEPS = 100
RESUME_AT = 50
RESUME_STEPS = 20
RESUME_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_resume.pt")


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean milliseconds per call on the card (CUDA events around `iters`
    back-to-back calls, after `warmup`). At small shapes this is the host's
    dispatch floor (wrapper checks, the ctypes call, the allocation), not
    the kernel: device_ms reads the kernel's own time."""
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


def device_events(torch, prof):
    """The device activity of a profile: kernels, copies and sets, not the
    ranges that record_function annotations project onto the device."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(torch, kernel_fn, kernel, library_fn=None, iters=20, warmup=3):
    """Device milliseconds per call, from torch.profiler: `warmup` calls of
    kernel_fn, then `iters` timed ones, then `iters` of library_fn (warmed
    up before the window). The kernel's time is that of the last `iters`
    kernels whose name holds `kernel`, over `iters` (the tracer can drop
    the first device events of a window, hence the warm-up inside it); the
    library call's is every other device operation after them, over
    `iters` (None without one). A window whose trace lost kernels is
    traced again, up to PROFILE_TRIES times. Returns (kernel, library)."""
    from torch.profiler import ProfilerActivity, profile

    if library_fn is not None:
        for _ in range(warmup):
            library_fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(warmup):
                kernel_fn()
            torch.cuda.synchronize()
            for _ in range(iters):
                kernel_fn()
            torch.cuda.synchronize()
            if library_fn is not None:
                for _ in range(iters):
                    library_fn()
                torch.cuda.synchronize()
        events = sorted(device_events(torch, prof), key=lambda e: e.time_range.start)
        mine = [e for e in events if kernel in e.name]
        if len(mine) >= iters:
            break
        print("profiler: %d device events of %s for %d timed calls (of %d events); tracing "
              "again" % (len(mine), kernel, iters, len(events)))
    check(len(mine) >= iters, "profiler: %d device events of %s for %d timed calls in %d tries"
          % (len(mine), kernel, iters, PROFILE_TRIES))
    mine = mine[-iters:]
    k_ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3 / iters
    check(k_ms > 0, "profiler: no device time for %s" % kernel)
    if library_fn is None:
        return k_ms, None
    last = mine[-1].time_range.start
    others = [e for e in events if kernel not in e.name and e.time_range.start > last]
    check(len(others) > 0, "profiler: no device time for the library call beside %s" % kernel)
    return k_ms, sum(e.time_range.elapsed_us() for e in others) / 1e3 / iters


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


def wide_cost(m):
    """Bytes and operations of one 128-row factor against [128, m]."""
    return solve_cost(1, 128, m)


def newton_cost(B, n, m, iters):
    """Bytes (Lk, y and var read once, v* written once) and operations of
    B Newton loops: an iteration of one model does 2nm for f = Lk v,
    about nm^2 for the system Lk^T |W| Lk, m^3/3 for its factor, 2m^2 for
    the two substitutions and 8nm for the four trial points' products."""
    nbytes = B * (n * m + n + 1 + m) * 4
    per_iter = 2 * n * m + n * m * m + m ** 3 // 3 + 2 * m * m + 8 * n * m
    return nbytes, B * iters * per_iter


def spd(torch, B, n, seed, device):
    """SPD batch, eigenvalues log-spaced in [0.01, 1], from a numpy seed."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    A = (Q * np.logspace(-2, 0, n)) @ np.swapaxes(Q, -1, -2)
    return torch.tensor(A.astype(np.float32), device=device)


def late_pivot(torch, B, n, bad, k, seed, device):
    """spd()'s batch with matrix `bad` made indefinite at pivot k: its
    [k, k] entry lowered by twice the square of its Cholesky pivot, so
    pivots 0..k-1 stay positive, pivot k comes out as minus the old one,
    and the matrix has one negative eigenvalue. NaN in every unread upper
    triangle."""
    A = spd(torch, B, n, seed, "cpu").double().numpy()
    A[bad, k, k] -= 2.0 * np.linalg.cholesky(A[bad])[k, k] ** 2
    A[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    return torch.tensor(A.astype(np.float32), device=device)


def lower(torch, B, n, seed, device):
    """Lower factors with unit-order diagonals and NaN above the diagonal."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(B, n, n)) * (0.5 / np.sqrt(n)))
    L[:, np.arange(n), np.arange(n)] = rng.uniform(1.0, 2.0, size=(B, n))
    iu = np.triu_indices(n, 1)
    L[:, iu[0], iu[1]] = np.nan
    return torch.tensor(L.astype(np.float32), device=device)


def newton_batch(torch, tag, B, n, m, seed, device):
    """(Lk, y, var) for K3: scaled RBF factors of sorted inputs on [0, 6]
    with sine targets and outliers (test_fused_newton.py's batch), or, for
    n != m, Gaussian projections (0.4 N(0, 1), its rectangular case);
    labels y > 0 for bernoulli_logit."""
    rng = np.random.default_rng(seed)
    if n == m:
        Lks, ys = [], []
        for b in range(B):
            X = np.sort(rng.uniform(0, 6, (n, 1)))
            K = np.exp(-0.5 * (X - X.T) ** 2 / 0.7 ** 2) + 1e-4 * np.eye(n)
            Lks.append(np.linalg.cholesky(K) * (1.0 + 0.2 * (b % 4)))
            y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
            y[::7] += 2.0
            ys.append(y)
        Lk, y = np.stack(Lks), np.stack(ys)
    else:
        Lk = rng.standard_normal((B, n, m)) * 0.4
        y = rng.standard_normal((B, n, 1))
    if tag == "bernoulli_logit":
        y = (y > 0).astype(np.float64)
    var = 0.15 + 0.05 * (np.arange(B) % 4)[:, None]
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (Lk, y, var))


def max_err(torch, got, want):
    """Largest |got - want| where want is finite; NaN must match NaN."""
    check(bool(torch.equal(torch.isnan(got), torch.isnan(want))), "NaN pattern differs")
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if finite.any() else 0.0


def kernel_phase(torch, hb):
    from henbun_tpu_torch.ops import cuda_chol, cuda_solve

    dev = "cuda"
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    times = {}
    for B, n in ((FLEET, N), (FLEET, GPC_N), (16, 128), (96, 128), (3, 7)):
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
        row["device_ms"], row["library_device_ms"] = device_ms(
            torch, lambda: cuda_chol.cholesky128_vbatched(A), "chol128",
            lambda: torch.linalg.cholesky_ex(A))
        times[("K1", B, n)] = row
        print("K1 cholesky B=%d n=%d max_abs_err=%.3g kernel_ms=%.4f device_ms=%.4f "
              "plain_ms=%.4f library_ms=%.4f library_device_ms=%.4f"
              % (B, n, err, row["ms"], row["device_ms"], row["plain_ms"], row["library_ms"],
                 row["library_device_ms"]))
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
    late_pivot_checks(torch, errs, "K1", cuda_chol.cholesky128_vbatched, FLEET)

    for B, n, m in ((FLEET, N, N), (FLEET, N, 1), (FLEET, GPC_N, GPC_N), (FLEET, GPC_N, 1),
                    (16, 128, 128), (16, 128, 1), (1, 128, 1)):
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
            row["device_ms"], row["library_device_ms"] = device_ms(
                torch, lambda: cuda_solve.tri_solve128_vbatched(Lf, R, transpose), "trisolve128",
                lambda: torch.linalg.solve_triangular(Lt.mT if transpose else Lt, R,
                                                      upper=transpose))
            times[("K2", B, n, m, transpose)] = row
            print("K2 tri_solve B=%d n=%d m=%d transpose=%s max_abs_err=%.3g kernel_ms=%.4f "
                  "device_ms=%.4f plain_ms=%.4f library_ms=%.4f library_device_ms=%.4f"
                  % (B, n, m, transpose, err, row["ms"], row["device_ms"], row["plain_ms"],
                     row["library_ms"], row["library_device_ms"]))
    natgrad_kernel_checks(torch, errs, times)
    bayes_kernel_checks(torch, errs, times)
    family_kernel_checks(torch, errs, times)
    newton_checks(torch, errs, times)
    small_chol_checks(torch, errs, times)
    wide_checks(torch, errs, times)
    return errs, times


def k1_row(torch, errs, A, what):
    """K1 on the SPD batch A against its plain version (error recorded in
    errs), with its and cholesky_ex's wall and device times and its bound."""
    from henbun_tpu_torch.ops import cuda_chol

    B, n = A.shape[0], A.shape[-1]
    L = cuda_chol.cholesky128_vbatched(A)
    torch.cuda.synchronize()
    err = max_err(torch, L, cuda_chol.cholesky128_plain(A))
    check(err <= KERNEL_ATOL, "K1 %s B=%d n=%d: max error %g" % (what, B, n, err))
    errs["K1"] = max(errs["K1"], err)
    row = {"ms": time_ms(torch, lambda: cuda_chol.cholesky128_vbatched(A)),
           "plain_ms": time_ms(torch, lambda: cuda_chol.cholesky128_plain(A), iters=3, warmup=1),
           "library_ms": time_ms(torch, lambda: torch.linalg.cholesky_ex(A)), "err": err}
    row["device_ms"], row["library_device_ms"] = device_ms(
        torch, lambda: cuda_chol.cholesky128_vbatched(A), "chol128",
        lambda: torch.linalg.cholesky_ex(A))
    row["bound_ms"], row["bound_by"] = bound(*chol_cost(B, n))
    return row


def k2_row(torch, errs, Lf, R, transpose, what):
    """K2 on (Lf, R) against its plain version (error recorded in errs),
    with its and solve_triangular's wall and device times and its bound."""
    from henbun_tpu_torch.ops import cuda_solve

    B, n, m = R.shape
    X = cuda_solve.tri_solve128_vbatched(Lf, R, transpose)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(X).all()), "K2 %s read the NaN triangle" % what)
    err = max_err(torch, X, cuda_solve.tri_solve128_plain(Lf, R, transpose))
    check(err <= KERNEL_ATOL, "K2 %s B=%d n=%d m=%d: max error %g" % (what, B, n, m, err))
    errs["K2"] = max(errs["K2"], err)
    Lt = torch.tril(torch.nan_to_num(Lf))
    library = lambda: torch.linalg.solve_triangular(Lt.mT if transpose else Lt, R,
                                                    upper=transpose)
    row = {"ms": time_ms(torch, lambda: cuda_solve.tri_solve128_vbatched(Lf, R, transpose)),
           "plain_ms": time_ms(torch, lambda: cuda_solve.tri_solve128_plain(Lf, R, transpose),
                               iters=3, warmup=1),
           "library_ms": time_ms(torch, library), "err": err}
    row["device_ms"], row["library_device_ms"] = device_ms(
        torch, lambda: cuda_solve.tri_solve128_vbatched(Lf, R, transpose), "trisolve128", library)
    row["bound_ms"], row["bound_by"] = bound(*solve_cost(B, n, m))
    return row


def print_row(label, r):
    print("%s max_abs_err=%.3g kernel_ms=%.4f device_ms=%.4f plain_ms=%.4f library_ms=%.4f "
          "library_device_ms=%.4f bound_ms=%.3g (%s)"
          % (label, r["err"], r["ms"], r["device_ms"], r["plain_ms"], r["library_ms"],
             r["library_device_ms"], r["bound_ms"], r["bound_by"]))


def natgrad_kernel_checks(torch, errs, times):
    """K1 and K2 at the natural gradient's shapes (NATGRAD_SHAPES): K1 on
    SPD batches, K2 as L X = I (the inverses natgrad takes, no
    transpose), each against its plain version, with cholesky_ex's and
    solve_triangular's device times beside them."""
    for B, n in NATGRAD_SHAPES:
        row = k1_row(torch, errs, spd(torch, B, n, seed=B * 7 + n, device="cuda"), "natgrad")
        times[("K1", B, n)] = row
        Lf = lower(torch, B, n, seed=B * 11 + n, device="cuda")
        eye = torch.eye(n, device="cuda").expand(B, n, n).contiguous()
        row2 = k2_row(torch, errs, Lf, eye, False, "natgrad")
        times[("K2", B, n, n, False, "eye")] = row2
        print_row("natgrad shape K1 cholesky B=%d n=%d" % (B, n), row)
        print_row("natgrad shape K2 tri_solve L X = I B=%d n=%d" % (B, n), row2)


def bayes_kernel_checks(torch, errs, times):
    """K1 and K2 at the Bayesian-hyperparameter path's shapes (a
    BAYES_CHAINS-chain gradient evaluation of SparseGPC at m = BAYES_M):
    K1 on [8, 32, 32] (each Newton factor, the IFT's, the evidence's and
    Kmm's), K2 on [8, 32, 1] both ways (the IFT's two solves) and on
    [8, 32, 32] transposed (the Murray backward)."""
    B, n = BAYES_CHAINS, BAYES_M
    times[("K1", B, n)] = row = k1_row(torch, errs, spd(torch, B, n, seed=77, device="cuda"),
                                       "bayes")
    print_row("bayes shape K1 cholesky B=%d n=%d" % (B, n), row)
    Lf = lower(torch, B, n, seed=78, device="cuda")
    for m, transpose in ((1, False), (1, True), (n, True)):
        R = torch.tensor(np.random.default_rng(m).normal(size=(B, n, m)).astype(np.float32),
                         device="cuda")
        times[("K2", B, n, m, transpose)] = row = k2_row(torch, errs, Lf, R, transpose, "bayes")
        print_row("bayes shape K2 tri_solve B=%d n=%d m=%d transpose=%s" % (B, n, m, transpose),
                  row)


def family_kernel_checks(torch, errs, times):
    """K1 and K2 at the shapes slice 9's paths give them: the hetero fleet
    (K1 on [16, 120, 120]; K2 on [16, 120, 120] transposed, the Murray
    backward), the multi-output natural gradient (K1 on [6, 80, 80], K2 as
    L X = I) and the per-latent predict_f (K2 on [2, 80, 100])."""
    for B, n in ((FLEET, HETERO_N), (3 * MO_Q, MO_N)):
        times[("K1", B, n)] = row = k1_row(
            torch, errs, spd(torch, B, n, seed=B * 13 + n, device="cuda"), "family")
        print_row("family shape K1 cholesky B=%d n=%d" % (B, n), row)
    rng = np.random.default_rng(9)
    for B, n, m, transpose, what in ((FLEET, HETERO_N, HETERO_N, True, "hetero fleet"),
                                     (3 * MO_Q, MO_N, MO_N, False, "natgrad"),
                                     (MO_Q, MO_N, MO_PREDICT, False, "predict_f")):
        Lf = lower(torch, B, n, seed=B * 17 + m, device="cuda")
        if what == "natgrad":
            R = torch.eye(n, device="cuda").expand(B, n, n).contiguous()
        else:
            R = torch.tensor(rng.normal(size=(B, n, m)).astype(np.float32), device="cuda")
        times[("K2", B, n, m, transpose, what)] = row = k2_row(torch, errs, Lf, R, transpose,
                                                              what)
        print_row("family shape (%s) K2 tri_solve B=%d n=%d m=%d transpose=%s"
                  % (what, B, n, m, transpose), row)


def late_pivot_checks(torch, errs, key, entry, B, n=128, k=100):
    """A pivot that fails past the first panels: matrix B // 3 of a
    B-batch at n = 128 made indefinite at pivot k (late_pivot). Its factor
    must be all NaN, every other one finite and within KERNEL_ATOL of the
    plain version."""
    from henbun_tpu_torch.ops import cuda_chol

    bad = B // 3
    A = late_pivot(torch, B, n, bad, k, seed=B + k, device="cuda")
    L = entry(A)
    torch.cuda.synchronize()
    check(bool(torch.isnan(L[bad]).all()), "%s: the matrix failing at pivot %d is not all NaN"
          % (key, k))
    check(bool(torch.isfinite(torch.cat([L[:bad], L[bad + 1:]])).all()),
          "%s: a late pivot failure leaked NaN into other matrices" % key)
    err = max_err(torch, L, cuda_chol.cholesky128_plain(A))
    check(err <= KERNEL_ATOL, "%s late pivot: max error %g" % (key, err))
    errs[key] = max(errs[key], err)
    print("%s late pivot (matrix %d of B=%d n=%d fails at pivot %d) NaN isolation ok "
          "max_abs_err=%.3g" % (key, bad, B, n, k, err))


def small_chol_checks(torch, errs, times):
    """K4 (one matrix) and K5 (a batch, one block a matrix) against the
    plain version, through their own entries; for K5 also one negated
    matrix with NaN in every unread upper triangle."""
    from henbun_tpu_torch.ops import cuda_chol

    errs["K4"] = errs["K5"] = 0.0
    for n in K4_N:
        A = spd(torch, 1, n, seed=n + 1, device="cuda")[0]
        L = cuda_chol.cholesky128(A)
        torch.cuda.synchronize()
        err = max_err(torch, L, cuda_chol.cholesky128_plain(A[None])[0])
        check(err <= KERNEL_ATOL, "K4 n=%d: max error %g" % (n, err))
        check(bool((torch.triu(L, 1) == 0).all()), "K4 wrote above the diagonal")
        errs["K4"] = max(errs["K4"], err)
        row = {
            "ms": time_ms(torch, lambda: cuda_chol.cholesky128(A)),
            "plain_ms": time_ms(torch, lambda: cuda_chol.cholesky128_plain(A[None]), iters=5,
                                warmup=1),
            "library_ms": time_ms(torch, lambda: torch.linalg.cholesky_ex(A)),
        }
        row["device_ms"], row["library_device_ms"] = device_ms(
            torch, lambda: cuda_chol.cholesky128(A), "chol128",
            lambda: torch.linalg.cholesky_ex(A))
        row["bound_ms"], row["bound_by"] = bound(*chol_cost(1, n))
        times[("K4", n)] = row
        print("K4 cholesky128 n=%d max_abs_err=%.3g kernel_ms=%.4f device_ms=%.4f plain_ms=%.4f "
              "library_ms=%.4f library_device_ms=%.4f bound_ms=%.3g (%s)"
              % (n, err, row["ms"], row["device_ms"], row["plain_ms"], row["library_ms"],
                 row["library_device_ms"], row["bound_ms"], row["bound_by"]))
    for B, n in K5_SHAPES:
        A = spd(torch, B, n, seed=B + n, device="cuda")
        L = cuda_chol.cholesky128_batched(A)
        torch.cuda.synchronize()
        err = max_err(torch, L, cuda_chol.cholesky128_plain(A))
        row = {
            "ms": time_ms(torch, lambda: cuda_chol.cholesky128_batched(A)),
            "plain_ms": time_ms(torch, lambda: cuda_chol.cholesky128_plain(A), iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.linalg.cholesky_ex(A)),
        }
        row["device_ms"], row["library_device_ms"] = device_ms(
            torch, lambda: cuda_chol.cholesky128_batched(A), "chol128",
            lambda: torch.linalg.cholesky_ex(A))
        bad = B // 3
        A[bad] = -A[bad]
        iu = torch.triu_indices(n, n, 1, device="cuda")
        A[:, iu[0], iu[1]] = float("nan")
        L = cuda_chol.cholesky128_batched(A)
        torch.cuda.synchronize()
        check(bool(torch.isnan(L[bad]).all()), "K5: the non-SPD matrix is not all NaN")
        check(bool(torch.isfinite(torch.cat([L[:bad], L[bad + 1:]])).all()),
              "K5: NaN leaked into other matrices or from the unread triangle")
        err = max(err, max_err(torch, L, cuda_chol.cholesky128_plain(A)))
        check(err <= KERNEL_ATOL, "K5 B=%d n=%d: max error %g" % (B, n, err))
        errs["K5"] = max(errs["K5"], err)
        row["bound_ms"], row["bound_by"] = bound(*chol_cost(B, n))
        times[("K5", B, n)] = row
        print("K5 cholesky128_batched B=%d n=%d NaN isolation ok max_abs_err=%.3g kernel_ms=%.4f "
              "device_ms=%.4f plain_ms=%.4f library_ms=%.4f library_device_ms=%.4f "
              "bound_ms=%.3g (%s)"
              % (B, n, err, row["ms"], row["device_ms"], row["plain_ms"], row["library_ms"],
                 row["library_device_ms"], row["bound_ms"], row["bound_by"]))
    late_pivot_checks(torch, errs, "K5", cuda_chol.cholesky128_batched, 256)


def wide_checks(torch, errs, times):
    """K6 in both modes at the listed widths against its plain version; the
    factor holds NaN in the triangle the mode must not read, and none may
    reach X."""
    from henbun_tpu_torch.ops import cuda_wide

    errs["K6"] = 0.0
    for upper in (False, True):
        entry = cuda_wide.wide_usolve128 if upper else cuda_wide.wide_lsolve128
        for m in WIDE_M:
            Lf = lower(torch, 1, 128, seed=m + upper, device="cuda")[0]  # NaN above
            T = Lf.mT.contiguous() if upper else Lf
            R = torch.tensor(np.random.default_rng(m).normal(size=(128, m)).astype(np.float32),
                             device="cuda")
            X = entry(T, R)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(X).all()), "K6 read the NaN triangle (upper=%s)" % upper)
            err = max_err(torch, X, cuda_wide.wide_solve128_plain(T, R, upper))
            check(err <= KERNEL_ATOL, "K6 upper=%s m=%d: max error %g" % (upper, m, err))
            errs["K6"] = max(errs["K6"], err)
            Tc = torch.nan_to_num(T, nan=0.0)
            row = {
                "ms": time_ms(torch, lambda: entry(T, R)),
                "plain_ms": time_ms(torch, lambda: cuda_wide.wide_solve128_plain(T, R, upper),
                                    iters=3, warmup=1),
                "library_ms": time_ms(
                    torch, lambda: torch.linalg.solve_triangular(Tc, R, upper=upper)),
            }
            row["device_ms"], row["library_device_ms"] = device_ms(
                torch, lambda: entry(T, R), "widesolve128",
                lambda: torch.linalg.solve_triangular(Tc, R, upper=upper))
            row["bound_ms"], row["bound_by"] = bound(*wide_cost(m))
            times[("K6", upper, m)] = row
            print("K6 %s m=%d cols=%d max_abs_err=%.3g kernel_ms=%.4f device_ms=%.4f "
                  "plain_ms=%.4f library_ms=%.4f library_device_ms=%.4f bound_ms=%.3g (%s)"
                  % (entry.__name__, m, cuda_wide.tile_cols(m), err, row["ms"],
                     row["device_ms"], row["plain_ms"],
                     row["library_ms"], row["library_device_ms"], row["bound_ms"],
                     row["bound_by"]))


def near_tie_check(torch, Lk, y, var, tag, v, want):
    """K3's largest error against the plain version over all but a tenth of
    the models (at most one), and every mode as good an optimum as the
    plain version's: psi at the kernel's mode at least psi at the plain
    version's less 1e-5 (1 + |psi|), the ladder's tie tolerance. Student-t
    modes are not determined to 1e-4 by float32 everywhere: where the
    ladder meets a near-tie, rounding in another order takes another step
    (the plain version against float64 misses 1e-4 on some models of these
    batches, and the parent kernel missed it too)."""
    from henbun_tpu_torch.ops import cuda_newton

    def psi(vv):
        ll = cuda_newton.lik_terms(tag, 3.0, y.double(), Lk.double() @ vv.double(),
                                   var.double().reshape(-1, 1, 1))[0]
        return ll.sum((1, 2)) - 0.5 * (vv.double() ** 2).sum((1, 2))

    diff = (v - want).abs().amax((1, 2))
    keep = diff.argsort()[: Lk.shape[0] - max(1, Lk.shape[0] // 10)]
    psi_k, psi_p = psi(v), psi(want)
    check(bool((psi_k >= psi_p - 1e-5 * (1 + psi_p.abs())).all()),
          "K3: a mode short of the plain version's optimum")
    print("K3 near-tie check: largest difference %.3g (model %d), psi short by at most %.3g "
          "of 1 + |psi|" % (float(diff.max()), int(diff.argmax()),
                            float(((psi_p - psi_k) / (1 + psi_p.abs())).max())))
    return float(diff[keep].max())


def newton_checks(torch, errs, times):
    """K3 against its plain version: both likelihoods at the Laplace
    fleet's shape and at n = m = 128, Bernoulli at the GPC fleet's shape,
    the rectangular (inducing-point) shape, a panel edge (n = m = 33,
    held as near_tie_check says), and one model's NaN target isolated from
    the other 15. No
    PyTorch call computes a Newton loop, so there is no library time."""
    from henbun_tpu_torch.ops import cuda_newton

    k3 = cuda_newton.newton_mode_vbatched
    shapes = [(tag, B, n, m) for B, n, m in ((FLEET, N, N), (FLEET, 128, 128))
              for tag in ("student_t", "bernoulli_logit")]
    shapes += [("bernoulli_logit", FLEET, GPC_N, GPC_N), ("bernoulli_logit", 4, 96, 24),
               ("student_t", FLEET, K3_EDGE, K3_EDGE)]
    for tag, B, n, m in shapes:
        Lk, y, var = newton_batch(torch, tag, B, n, m, seed=n + m, device="cuda")
        v = k3(Lk, y, var, tag, df=3.0)
        torch.cuda.synchronize()
        want = cuda_newton.newton_mode_plain(Lk, y, var, tag, df=3.0)
        check(bool(torch.isfinite(v).all()), "K3 %s B=%d n=%d m=%d: mode not finite" % (tag, B, n, m))
        if n == K3_EDGE:
            err = near_tie_check(torch, Lk, y, var, tag, v, want)
        else:
            err = max_err(torch, v, want)
        check(err <= NEWTON_ATOL[tag], "K3 %s B=%d n=%d m=%d: max error %g" % (tag, B, n, m, err))
        errs["K3"] = max(errs["K3"], err)
        row = {
            "ms": time_ms(torch, lambda: k3(Lk, y, var, tag, df=3.0), iters=20, warmup=2),
            "plain_ms": time_ms(
                torch, lambda: cuda_newton.newton_mode_plain(Lk, y, var, tag, df=3.0),
                iters=2, warmup=1,
            ),
            "library_ms": None,
            "library_device_ms": None,
        }
        row["device_ms"] = device_ms(torch, lambda: k3(Lk, y, var, tag, df=3.0), "newton128",
                                     iters=5, warmup=1)[0]
        row["bound_ms"], row["bound_by"] = bound(*newton_cost(B, n, m, 15))
        times[("K3", tag, B, n, m)] = row
        print("K3 newton %s B=%d n=%d m=%d iters=15 max_abs_err=%.3g kernel_ms=%.4f "
              "device_ms=%.4f plain_ms=%.3f bound_ms=%.3g (%s) library_ms=null"
              % (tag, B, n, m, err, row["ms"], row["device_ms"], row["plain_ms"],
                 row["bound_ms"], row["bound_by"]))
    # NaN isolation: one model's target NaN; that model keeps v = 0 and the
    # other 15 modes equal those of the run without it
    Lk, y, var = newton_batch(torch, "student_t", FLEET, N, N, seed=7, device="cuda")
    clean = k3(Lk, y, var, "student_t", df=3.0)
    y[5, 3] = float("nan")
    v = k3(Lk, y, var, "student_t", df=3.0)
    torch.cuda.synchronize()
    check(bool((v[5] == 0).all()), "K3: the NaN model moved")
    others = [i for i in range(FLEET) if i != 5]
    check(bool(torch.equal(v[others], clean[others])), "K3: NaN reached another model")
    err = max_err(torch, v, cuda_newton.newton_mode_plain(Lk, y, var, "student_t", df=3.0))
    check(err <= NEWTON_ATOL["student_t"], "K3 NaN isolation: max error %g" % err)
    print("K3 newton NaN isolation B=%d n=%d ok max_abs_err=%.3g" % (FLEET, N, err))


def robust_toy(n, seed, outliers=4):
    """benchmarks/laplace_bench.py's data: sin(x) + 0.3 N(0, 1) on sorted
    uniform inputs in [0, 6], with `outliers` points moved by +-3."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    y = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.3
    idx = rng.choice(n, outliers, replace=False)
    y[idx] += rng.choice([-3.0, 3.0], outliers)[:, None]
    return X.astype(np.float32), y.astype(np.float32)


def gpc_data(n, seed):
    """tests/test_gpc.py's data: labels drawn from sigmoid(3 sin x) on
    sorted uniform inputs in [-3, 3]."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, n)).astype(np.float32)[:, None]
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p_true).astype(np.float32)


# kind -> (objective, learning rate)
FLEETS = {
    "gpr": ("ELBO_gaussian", 0.01),
    "laplace": ("log_marginal_laplace_student", 0.02),
    "gpc": ("log_marginal_laplace", 0.05),
    "ep_gpr": ("log_marginal_ep_student", 0.02),
    "ep_gpc": ("log_marginal_ep", 0.05),
    "sparse": ("log_marginal_laplace", 0.05),
}


def make_models(hb, device, kind):
    hb.set_seed(0)
    models = []
    for i in range(FLEET):
        if kind == "gpr":
            X, Y = hb.models.make_sine_dataset(n=N, seed=i)
        elif kind in ("laplace", "ep_gpr"):
            X, Y = robust_toy(N, seed=i)
        elif kind == "sparse":
            X, Y = gpc_data(SPARSE_FLEET_N, seed=i)
            models.append(hb.models.SparseGPC(seed=i, X=X, Y=Y, num_inducing=SPARSE_FLEET_M,
                                              device=device))
            continue
        else:
            X, Y = gpc_data(GPC_N, seed=i)
        cls = hb.models.GPC if kind in ("gpc", "ep_gpc") else hb.models.GPR
        models.append(cls(seed=i, X=X, Y=Y, device=device))
    return models


def make_fleet(hb, device, kind="gpr"):
    method, lr = FLEETS[kind]
    return hb.BatchedOptimizer(make_models(hb, device, kind), method).compile(learning_rate=lr)


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


def kernel_counters():
    from henbun_tpu_torch.ops import cuda_chol, cuda_newton, cuda_solve

    return {"K1": cuda_chol.cholesky128_vbatched, "K2": cuda_solve.tri_solve128_vbatched,
            "K3": cuda_newton.newton_mode_vbatched}


def laplace_phase(torch, hb):
    """The Laplace evidence fleets: 16 robust GPRs for LAPLACE_STEPS and 16
    GPCs for GPC_STEPS, each with every kernel count set to 0 just before
    and read just after. Each step must launch K3 at least once, K1 and
    K2 at all; the evidence must stay finite and rise, the fitted
    hyperparameters be finite, and each fit end at a mode (grad_norm < 1,
    as test_laplace.py asks)."""
    counters = kernel_counters()
    out = {}
    for kind, steps in (("laplace", LAPLACE_STEPS), ("gpc", GPC_STEPS)):
        bo = make_fleet(hb, "cuda", kind)
        with hb.settings.temp_settings(settings_with(hb, scan_chunk=CHUNK)):
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bo.optimize(maxiter=steps)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        hist = np.concatenate(bo.history)
        check(hist.shape == (steps,) and np.isfinite(hist).all(), "%s evidence not finite" % kind)
        # the first and last 20 steps (the GPC fit is a single chunk)
        first, last = float(np.mean(hist[:20])), float(np.mean(hist[-20:]))
        check(last > first, "%s evidence did not rise (%g -> %g)" % (kind, first, last))
        check(launches["K3"] >= steps, "K3 launched %d times in %d %s steps"
              % (launches["K3"], steps, kind))
        check(launches["K1"] > 0 and launches["K2"] > 0, "%s: K1 or K2 never launched %r"
              % (kind, launches))
        names = ("k_var", "var") if kind == "laplace" else ("k_var",)
        for name in names:
            vals = np.array([getattr(m, name).value[0] for m in bo.models])
            check(np.isfinite(vals).all(), "%s: fitted %s not finite" % (kind, name))
        fit = (lambda mm: mm.laplace_student()) if kind == "laplace" else (lambda mm: mm.laplace())
        gnorm = np.array([float(m.run(fit).grad_norm) for m in bo.models])
        check(np.isfinite(gnorm).all() and (gnorm < 1).all(),
              "%s: grad_norm after the fit %s" % (kind, gnorm))
        print("laplace path: %s fleet=%d steps=%d chunk=%d seconds=%.3f steps_per_s=%.1f "
              "evidence first20_mean=%.3f last20_mean=%.3f launches K1=%d K2=%d K3=%d "
              "per_step K1=%.3f K2=%.3f K3=%.3f max_grad_norm=%.3g"
              % (kind, FLEET, steps, CHUNK, seconds, steps / seconds, first, last,
                 launches["K1"], launches["K2"], launches["K3"], launches["K1"] / steps,
                 launches["K2"] / steps, launches["K3"] / steps, gnorm.max()))
        out[kind] = (launches, steps / seconds)
    return out


def laplace_agreement_phase(torch, hb):
    """For the Laplace and the GPC fleet: 20 steps with the kernels
    against 20 with use_kernels off (no kernel may launch then; evidence
    within 1e-4 of its scale), and the fleet's evidence on the card
    against the CPU's (plain versions) under the same weights (rtol 1e-4).
    Then the Laplace fleet's steps/s with the kernels on and off, in turns
    (on, off, on, off)."""
    counters = kernel_counters()
    for kind in ("laplace", "gpc"):
        runs = {}
        for use_kernels in (True, False):
            bo = make_fleet(hb, "cuda", kind)
            with hb.settings.temp_settings(
                settings_with(hb, scan_chunk=CHECK_STEPS, use_kernels=use_kernels)
            ):
                before = {k: c.launches for k, c in counters.items()}
                bo.optimize(maxiter=CHECK_STEPS)
                after = {k: c.launches for k, c in counters.items()}
            if not use_kernels:
                check(after == before, "%s: use_kernels off still launched a kernel: %r -> %r"
                      % (kind, before, after))
            runs[use_kernels] = bo.history[-1]
        diff = np.abs(runs[True] - runs[False])
        rel = float(diff.max() / np.abs(runs[False]).max())
        check(rel <= 1e-4, "%s kernels vs use_kernels=False: evidence differs by %g of its "
              "scale" % (kind, rel))
        print("laplace agreement: %s %d steps kernels vs use_kernels=False max_diff/scale=%.3g "
              "per_step_max_rel=%.3g"
              % (kind, CHECK_STEPS, rel, float((diff / np.abs(runs[False])).max())))

        method, lr = FLEETS[kind]
        on_card = make_fleet(hb, "cuda", kind)
        params = {k: v.detach().cpu() for k, v in on_card._trainable.items()}
        cpu_models = make_models(hb, "cpu", kind)
        for i, m in enumerate(cpu_models):
            m.set_param_dict({k: v[i] for k, v in params.items()})
        on_cpu = hb.BatchedOptimizer(cpu_models, method).compile(learning_rate=lr)
        v_card, v_cpu = float(on_card.run()), float(on_cpu.run())
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        check(rel <= 1e-4, "%s fleet evidence card %g vs CPU %g" % (kind, v_card, v_cpu))
        print("laplace reference: %s fleet evidence card=%.6f cpu=%.6f rel_diff=%.3g"
              % (kind, v_card, v_cpu, rel))

    rates = {True: [], False: []}
    for use_kernels in (True, False, True, False):
        bo = make_fleet(hb, "cuda", "laplace")
        with hb.settings.temp_settings(
            settings_with(hb, scan_chunk=RATE_STEPS, use_kernels=use_kernels)
        ):
            bo.optimize(maxiter=5)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bo.optimize(maxiter=RATE_STEPS)
            torch.cuda.synchronize()
            rates[use_kernels].append(RATE_STEPS / (time.perf_counter() - t0))
    print("laplace rate: fleet=%d steps=%d steps_per_s kernels_on=%s kernels_off=%s"
          % (FLEET, RATE_STEPS, " ".join("%.2f" % r for r in rates[True]),
             " ".join("%.2f" % r for r in rates[False])))


def profile_phase(torch, hb, kind="gpr", steps=PROFILE_STEPS):
    """A traced window of fleet steps (see profile_window)."""
    return profile_window(torch, hb, "%s fleet" % kind, make_fleet(hb, "cuda", kind), steps)


def profile_window(torch, hb, label, opt, steps, **optimize_kw):
    """A traced window of `steps` optimization steps after as many to warm
    up: device time by kernel and the share of the window the card was
    busy (torch.profiler, CPU and CUDA). Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile

    with hb.settings.temp_settings(settings_with(hb, scan_chunk=steps)):
        opt.optimize(maxiter=steps, **optimize_kw)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.optimize(maxiter=steps, **optimize_kw)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(torch, prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print("profile: %s %d steps wall_ms=%.3f device_busy_ms=%.3f busy_share=%.4f "
          "device_ops=%d per_step=%.1f"
          % (label, steps, wall_ms, busy_ms, busy_ms / wall_ms, len(events),
             len(events) / steps))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print("  device %.3f ms (%.1f%% of busy) %s" % (ms, 100 * ms / max(busy_ms, 1e-9), name[:90]))
    # the port's kernels, each summed over its instantiations
    shares = {src: sum(ms for name, ms in by_name.items() if src in name)
              for src in ("chol128", "trisolve128", "newton128", "widesolve128")}
    print("  kernels' share of busy: %s" % ", ".join(
        "%s %.3f ms (%.1f%%)" % (src, ms, 100 * ms / max(busy_ms, 1e-9))
        for src, ms in shares.items()))
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    for a in host:
        print("  host self %.3f ms x%d %s" % (a.self_cpu_time_total / 1e3, a.count, a.key[:70]))
    return busy_ms / wall_ms


def busy_window(torch, hb, label, opt, steps, run=None, **optimize_kw):
    """A traced window of `steps` optimization steps of a path that has just
    run (or of `run()`, which takes them), with the card's activity only
    (torch.profiler, CUDA): the share of the window the card was busy,
    device operations a step and the kernels that took most of the busy
    time. Recording no host activity keeps the report to seconds for
    windows of 10,000-40,000 device operations. Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile

    with hb.settings.temp_settings(settings_with(hb, scan_chunk=steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if run is None:
                opt.optimize(maxiter=steps, **optimize_kw)
            else:
                run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(torch, prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print("profile: %s %d steps wall_ms=%.3f device_busy_ms=%.3f busy_share=%.4f "
          "device_ops=%d per_step=%.1f"
          % (label, steps, wall_ms, busy_ms, busy_ms / wall_ms, len(events),
             len(events) / steps))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print("  device %.3f ms (%.1f%% of busy) %s" % (ms, 100 * ms / max(busy_ms, 1e-9), name[:90]))
    shares = {src: sum(ms for name, ms in by_name.items() if src in name)
              for src in ("chol128", "trisolve128", "newton128")}
    print("  kernels' share of busy: %s" % ", ".join(
        "%s %.3f ms (%.1f%%)" % (src, ms, 100 * ms / max(busy_ms, 1e-9))
        for src, ms in shares.items()))
    return busy_ms / wall_ms


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


def rel_err(torch, got, want):
    """max |got - want| over max |want|; NaN anywhere fails."""
    check(bool(torch.isfinite(got).all()), "non-finite result")
    return float((got - want).abs().max() / want.abs().max())


def blocked_phase(torch, hb):
    """ops/blocked.py against torch.linalg at n = 2048 and 4096 (error
    relative to the reference's largest entry, both times), then, at each
    panel width of blocked_cholesky and at the m = n width of
    blocked_tri_solve, the K2-chunked diagonal solve (_diag_solve, what
    the loop runs) against K6. Returns {n: {...}} for the summary."""
    from henbun_tpu_torch.ops import blocked, cuda_wide

    out = {}
    for n in BLOCKED_N:
        iters = 3 if n < max(BLOCKED_N) else 5  # the n = 2048 variant is the shorter
        g = torch.Generator(device="cuda")
        g.manual_seed(n)
        G = torch.randn(n, n, generator=g, device="cuda")
        A = G @ G.T / n + 2.0 * torch.eye(n, device="cuda")
        Lx, info = torch.linalg.cholesky_ex(A)
        check(int(info) == 0, "blocked: the test matrix is not SPD")
        err = rel_err(torch, blocked.blocked_cholesky(A), Lx)
        check(err <= BLOCKED_RTOL, "blocked_cholesky n=%d: error %g of max|L|" % (n, err))
        row = {"chol_err": err,
               "chol_ms": time_ms(torch, lambda: blocked.blocked_cholesky(A), iters, 1),
               "chol_lib_ms": time_ms(torch, lambda: torch.linalg.cholesky_ex(A), iters, 1)}
        R = torch.randn(n, n, generator=g, device="cuda")
        for transpose in (False, True):
            Xx = torch.linalg.solve_triangular(Lx.mT if transpose else Lx, R, upper=transpose)
            err = rel_err(torch, blocked.blocked_tri_solve(Lx, R, transpose), Xx)
            check(err <= BLOCKED_RTOL, "blocked_tri_solve n=%d T=%s: error %g of max|X|"
                  % (n, transpose, err))
            row["solve_err_%d" % transpose] = err
            row["solve_ms_%d" % transpose] = time_ms(
                torch, lambda: blocked.blocked_tri_solve(Lx, R, transpose), iters, 1)
            row["solve_lib_ms_%d" % transpose] = time_ms(
                torch, lambda: torch.linalg.solve_triangular(
                    Lx.mT if transpose else Lx, R, upper=transpose), iters, 1)
        print("blocked n=%d cholesky err=%.3g blocked_ms=%.3f cholesky_ex_ms=%.3f ratio=%.2f; "
              "tri_solve m=n T=False err=%.3g blocked_ms=%.3f solve_triangular_ms=%.3f ratio=%.2f; "
              "T=True err=%.3g blocked_ms=%.3f solve_triangular_ms=%.3f ratio=%.2f"
              % (n, row["chol_err"], row["chol_ms"], row["chol_lib_ms"],
                 row["chol_ms"] / row["chol_lib_ms"], row["solve_err_0"], row["solve_ms_0"],
                 row["solve_lib_ms_0"], row["solve_ms_0"] / row["solve_lib_ms_0"],
                 row["solve_err_1"], row["solve_ms_1"], row["solve_lib_ms_1"],
                 row["solve_ms_1"] / row["solve_lib_ms_1"]))

        # the panel solves: one diagonal factor against each panel width
        L128 = Lx[:128, :128].contiguous()
        U128 = L128.mT.contiguous()  # K6's upper mode reads U; the transpose is hoisted
        k2_sum = k6_sum = 0.0
        shown = []
        for w in range(n - 128, 0, -128):
            Bw = torch.randn(128, w, generator=g, device="cuda")
            err = rel_err(torch, cuda_wide.wide_lsolve128(L128, Bw),
                          blocked._diag_solve(L128, Bw, False))
            check(err <= BLOCKED_RTOL, "K6 vs K2-chunked at width %d: %g" % (w, err))
            t2 = time_ms(torch, lambda: blocked._diag_solve(L128, Bw, False), 10, 2)
            t6 = time_ms(torch, lambda: cuda_wide.wide_lsolve128(L128, Bw), 10, 2)
            k2_sum += t2
            k6_sum += t6
            if w in (n - 128, 1024, 128):
                shown.append("w=%d K2=%.4f K6=%.4f" % (w, t2, t6))
        Bn = torch.randn(128, n, generator=g, device="cuda")
        tT = {}
        for transpose in (False, True):
            t2 = time_ms(torch, lambda: blocked._diag_solve(L128, Bn, transpose), 10, 2)
            t6 = time_ms(torch, (lambda: cuda_wide.wide_usolve128(U128, Bn)) if transpose
                         else (lambda: cuda_wide.wide_lsolve128(L128, Bn)), 10, 2)
            tT[transpose] = (t2, t6)
        print("panels n=%d: cholesky's %d widths summed K2-chunked_ms=%.4f K6_ms=%.4f "
              "K6/K2=%.2f (%s); tri_solve width m=%d K2-chunked/K6 ms: L %.4f/%.4f, L^T "
              "%.4f/%.4f (K6 upper on the hoisted L^T)"
              % (n, n // 128 - 1, k2_sum, k6_sum, k6_sum / k2_sum, ", ".join(shown), n,
                 tT[False][0], tT[False][1], tT[True][0], tT[True][1]))
        row.update(k2_sum=k2_sum, k6_sum=k6_sum)
        out[n] = row
    return out


def marginal_data(n, seed=0):
    """Sorted U[0, 6] inputs, y = sin(x) + 0.3 N(0, 1), numpy seed."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, n)).astype(np.float32)[:, None]
    Y = (np.sin(X) + 0.3 * rng.standard_normal(X.shape)).astype(np.float32)
    return X, Y


def value_and_grad(opt, noise=None, rows=None):
    """An Optimizer's objective and gradients at its current weights (the
    leaves the objective reaches); `noise` ({path: u}) is injected on the
    optimizer's device and float type, `rows` (host indices) select the
    minibatch rows."""
    import torch

    for t in opt._trainable.values():
        t.grad = None
    data = opt._data_args()
    if rows is not None:
        data = opt._take_rows(data, torch.as_tensor(rows, device=opt.device))
    if noise is not None:
        dtype = next(iter(opt._trainable.values())).dtype
        noise = {k: v.to(device=opt.device, dtype=dtype) for k, v in noise.items()}
    val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen, data,
                                    opt.model.generator, noise)
    val.backward()
    return val.item(), {k: t.grad.detach().cpu().numpy() for k, t in opt._trainable.items()
                        if t.grad is not None}


def marginal_phase(torch, hb):
    """The exact-gram path: GPRMarginal at n = 4096 on the card. The
    evidence and its gradients at the initial weights against the CPU's
    (rtol 1e-4 of the evidence, and of each gradient leaf's largest
    entry), 50 Adam steps (lr 0.01) in one chunk with every kernel count
    set to 0 just before and read just after, predict_f at 1,000 new
    points, a traced window of 10 steps."""
    X, Y = marginal_data(MARGINAL_N)
    hb.set_seed(0)
    model = hb.models.GPRMarginal(seed=0, X=X, Y=Y)
    opt = model.log_marginal().compile(learning_rate=0.01)
    v_card, g_card = value_and_grad(opt)
    cpu = hb.models.GPRMarginal(seed=0, X=X, Y=Y, device="cpu")
    cpu.set_param_dict({k: v.detach().cpu() for k, v in model.param_dict().items()})
    t0 = time.perf_counter()
    v_cpu, g_cpu = value_and_grad(cpu.log_marginal().compile(learning_rate=0.01))
    cpu_s = time.perf_counter() - t0
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    check(rel <= 1e-4, "GPRMarginal evidence card %g vs CPU %g" % (v_card, v_cpu))
    grel = {k: float(np.abs(g_card[k] - g_cpu[k]).max() / np.abs(g_cpu[k]).max()) for k in g_cpu}
    check(max(grel.values()) <= 1e-4, "GPRMarginal gradient card vs CPU %r" % grel)
    print("marginal reference: n=%d evidence card=%.6f cpu=%.6f rel_diff=%.3g grad rel_diff %s "
          "(CPU value and gradient %.2f s)"
          % (MARGINAL_N, v_card, v_cpu, rel,
             " ".join("%s=%.3g" % kv for kv in sorted(grel.items())), cpu_s))

    counters = all_counters()
    with hb.settings.temp_settings(settings_with(hb, scan_chunk=MARGINAL_STEPS)):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize(maxiter=MARGINAL_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    hist = opt.history[-1]
    check(hist.shape == (MARGINAL_STEPS,) and np.isfinite(hist).all(),
          "GPRMarginal evidence not finite")
    check(hist[-1] > hist[0], "GPRMarginal evidence did not rise (%g -> %g)" % (hist[0], hist[-1]))
    x_new = np.linspace(-0.5, 6.5, MARGINAL_PREDICT, dtype=np.float32)[:, None]
    mean, var = model.run(lambda mm: mm.predict_f(x_new))
    check(mean.shape == (MARGINAL_PREDICT, 1) and var.shape == (MARGINAL_PREDICT, 1),
          "predict_f shapes %s %s" % (tuple(mean.shape), tuple(var.shape)))
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all() and (var >= 0).all()),
          "predict_f: non-finite mean or negative variance")
    fitted = {k: float(getattr(model, k).value[0]) for k in ("k_var", "var")}
    fitted["lengthscale"] = float(model.kern.lengthscales.value[0])
    print("marginal path: n=%d steps=%d chunk=%d seconds=%.3f steps_per_s=%.2f ms_per_step=%.2f "
          "evidence first=%.3f last=%.3f fitted %s launches %s predict_f n*=%d var_min=%.3g"
          % (MARGINAL_N, MARGINAL_STEPS, MARGINAL_STEPS, seconds, MARGINAL_STEPS / seconds,
             1e3 * seconds / MARGINAL_STEPS, hist[0], hist[-1],
             " ".join("%s=%.4f" % kv for kv in sorted(fitted.items())),
             " ".join("%s=%d" % kv for kv in sorted(launches.items())), MARGINAL_PREDICT,
             float(var.min())))
    busy = profile_window(torch, hb, "GPRMarginal n=%d" % MARGINAL_N, opt, MARGINAL_PROFILE_STEPS)
    ms_murray, ms_native = backward_phase(torch, hb, X, Y, fitted)
    return {"launches": launches, "steps_per_s": MARGINAL_STEPS / seconds, "busy": busy,
            "murray_ms": ms_murray, "native_ms": ms_native}


def backward_phase(torch, hb, X, Y, fitted):
    """The exact-gram evidence step (value and gradient in the three
    hyperparameters, at the fitted ones) with safe_cholesky and tri_solve
    (Murray backward: two [n, n] triangular solves) against
    torch.linalg.cholesky and solve_triangular under autograd's native
    gradient, BACKWARD_STEPS steps a turn in turns Murray, native,
    native, Murray. The two must agree (rtol 1e-4 of the evidence, 1e-3
    of each gradient: two float32 backwards in another order)."""
    from henbun_tpu_torch.ops import linalg

    Xt = torch.tensor(X, device="cuda")
    Yt = torch.tensor(Y, device="cuda")
    n = Xt.shape[0]
    eye = torch.eye(n, device="cuda")
    start = [fitted["lengthscale"], fitted["k_var"], fitted["var"]]

    def step(native):
        theta = torch.tensor(np.log(start), dtype=torch.float32, device="cuda",
                             requires_grad=True)
        ls, k_var, var = torch.exp(theta)
        Xs = Xt / ls
        d2 = -2 * linalg.matmul_hp(Xs, Xs.mT) + Xs.square().sum(-1)[:, None] + Xs.square().sum(-1)
        S = k_var * torch.exp(-d2 / 2) + var * eye
        if native:
            L = torch.linalg.cholesky(S + 1e-6 * eye)
            alpha = torch.linalg.solve_triangular(L, Yt, upper=False)
        else:
            L = linalg.safe_cholesky(S, 1e-6)
            alpha = linalg.tri_solve(L, Yt)
        val = -0.5 * torch.sum(alpha ** 2) - torch.sum(torch.log(torch.diagonal(L)))
        val.backward()
        return val, theta.grad

    results = {True: step(True), False: step(False)}
    v_n, g_n = (t.detach().cpu().numpy() for t in results[True])
    v_m, g_m = (t.detach().cpu().numpy() for t in results[False])
    check(abs(v_m - v_n) <= 1e-4 * abs(v_n), "Murray vs native evidence %g vs %g" % (v_m, v_n))
    check(np.all(np.abs(g_m - g_n) <= 1e-3 * np.abs(g_n).max()),
          "Murray vs native gradient %s vs %s" % (g_m, g_n))
    ms = {True: [], False: []}
    for native in (False, True, True, False):
        step(native)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BACKWARD_STEPS):
            step(native)
        torch.cuda.synchronize()
        ms[native].append(1e3 * (time.perf_counter() - t0) / BACKWARD_STEPS)
    print("cholesky backward n=%d evidence step ms: murray=%s native=%s murray/native=%.3f "
          "(grad murray %s native %s)"
          % (n, " ".join("%.3f" % t for t in ms[False]), " ".join("%.3f" % t for t in ms[True]),
             np.mean(ms[False]) / np.mean(ms[True]), np.array2string(g_m, precision=4),
             np.array2string(g_n, precision=4)))
    return float(np.mean(ms[False])), float(np.mean(ms[True]))


def run_path(torch, hb, opt, steps, **optimize_kw):
    """`steps` optimization steps in chunks of SLICE_CHUNK with every
    kernel count set to 0 just before and read just after. Returns
    (objective history, seconds, launches)."""
    counters = all_counters()
    with hb.settings.temp_settings(settings_with(hb, scan_chunk=SLICE_CHUNK)):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize(maxiter=steps, **optimize_kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    hist = np.concatenate(opt.history)[-steps:]
    return hist, seconds, launches


def check_rises(hist, label, window):
    """Finite, and the mean of the last `window` steps (at most half of
    them) above the first's."""
    check(np.isfinite(hist).all(), "%s: objective not finite" % label)
    window = min(window, len(hist) // 2)
    first, last = float(np.mean(hist[:window])), float(np.mean(hist[-window:]))
    check(last > first, "%s: objective did not rise (%g -> %g)" % (label, first, last))
    return first, last


def amortized_phase(torch, hb):
    """Amortized SVI at BASELINE config 3's width: AmortizedRegression
    (d_z = 4, hidden = 64) on make_synthetic_regression(n = 1e6, d_x = 8),
    the data whole on the card, Adam 0.003, minibatches of 1,024 rows;
    500 steps with diagonal locals and 300 with fullrank_packed ones.
    The ELBO must stay finite and its mean over the last 100 steps (per
    data point) exceed the first 100's; the objective on the card must
    match the CPU's (rtol 1e-4) at the same weights, rows and noise. No
    hand kernel runs on this path (none does in the reference)."""
    X, Y = hb.models.make_synthetic_regression(n=AMORT_N, d_x=8, seed=0)
    out = {}
    for q_local, steps in AMORT_STEPS.items():
        hb.set_seed(0)
        model = hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=4, hidden=64,
                                              q_local=q_local)
        opt = model.ELBO().compile(hb.adam(0.003))
        rng = np.random.default_rng(1)
        rows = rng.choice(AMORT_N, MINIBATCH, replace=False)
        u = torch.tensor(rng.standard_normal((MINIBATCH, 4)).astype(np.float32))
        elbo = hb.models.AmortizedRegression.ELBO.__wrapped__
        v_card = float(model.run(elbo, minibatch_index=rows, noise={"z": u.to(model.device)}))
        cpu = hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=4, hidden=64,
                                            q_local=q_local, device="cpu")
        cpu.set_param_dict({k: v.detach().cpu() for k, v in model.param_dict().items()})
        v_cpu = float(cpu.run(elbo, minibatch_index=rows, noise={"z": u}))
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        check(rel <= 1e-4, "amortized %s ELBO card %g vs CPU %g" % (q_local, v_card, v_cpu))
        hist, seconds, launches = run_path(torch, hb, opt, steps, minibatch_size=MINIBATCH)
        first, last = check_rises(hist / AMORT_N, "amortized " + q_local, 100)
        rate = steps / seconds
        print("amortized path: q_local=%s n=%d d_z=4 hidden=64 minibatch=%d steps=%d "
              "seconds=%.3f steps_per_s=%.1f examples_per_s=%.0f elbo_per_point first100=%.4f "
              "last100=%.4f launches %s; card vs CPU ELBO %.6f / %.6f rel_diff=%.3g"
              % (q_local, AMORT_N, MINIBATCH, steps, seconds, rate, rate * MINIBATCH, first,
                 last, " ".join("%s=%d" % kv for kv in sorted(launches.items())), v_card,
                 v_cpu, rel))
        busy = profile_window(torch, hb, "amortized %s" % q_local, opt, SLICE_PROFILE_STEPS,
                              minibatch_size=MINIBATCH)
        out[q_local] = {"steps_per_s": rate, "busy": busy}
    return out


def svgp_data(n):
    """benchmarks/svgp_bench.py's data: U[0, 6] inputs, sin(x) + 0.3 N(0, 1)
    targets, labels from sigmoid(3 sin(1.5 x - 3)), numpy seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 6, size=(n, 1)).astype(np.float32)
    Y = (np.sin(X) + rng.normal(size=X.shape) * 0.3).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X * 1.5 - 3.0)))
    Yc = (rng.uniform(size=X.shape) < p_true).astype(np.float32)
    return X, Y, Yc


# name -> (family, objective, analytic_kl, optimizer factory of the model);
# the pairings the reference's docs record as training (docs/PERF.md:209-216)
SVGP_PAIRINGS = {
    "reg ELBO + adam(0.02)": ("reg", "ELBO", False, lambda hb, m: hb.adam(0.02)),
    "reg ELBO_analytic + natgrad(1.0)": (
        "reg", "ELBO_analytic", True,
        lambda hb, m: hb.optimizers.natural_gradient(m, gamma=1.0, rest=hb.adam(0.005))),
    "cls ELBO_quadrature + natgrad(0.1)": (
        "cls", "ELBO_quadrature", True,
        lambda hb, m: hb.optimizers.natural_gradient(m, gamma=0.1, rest=hb.adam(0.01))),
}


def svgp_model(hb, data, family, analytic_kl, device=None):
    X, Y, Yc = data
    hb.set_seed(0)
    if family == "reg":
        return hb.models.SVGPRegression(seed=0, X=X, Y=Y, num_inducing=SVGP_M,
                                        analytic_kl=analytic_kl, device=device)
    return hb.models.SVGPClassification(seed=0, X=X, Y=Yc, num_inducing=SVGP_M, device=device)


def svgp_phase(torch, hb):
    """The SVGP families at svgp_bench.py's width (n = 1e6, m = 128,
    minibatch 1,024, block mode), SVGP_STEPS steps of each pairing in
    SVGP_PAIRINGS: objective finite and rising, K1 and K2 launches a step
    counted; then natgrad_checks on the two natural-gradient pairings."""
    data = svgp_data(SVGP_N)
    out = {}
    for name, (family, method, analytic_kl, make_opt) in SVGP_PAIRINGS.items():
        model = svgp_model(hb, data, family, analytic_kl)
        opt = getattr(model, method)().compile(make_opt(hb, model))
        kw = dict(minibatch_size=MINIBATCH, minibatch_mode="block")
        hist, seconds, launches = run_path(torch, hb, opt, SVGP_STEPS, **kw)
        first, last = check_rises(hist / SVGP_N, "svgp " + name, 50)
        natgrad = "natgrad" in name
        if natgrad:
            check(launches["K1"] >= 2 * SVGP_STEPS and launches["K2"] >= 2 * SVGP_STEPS,
                  "svgp %s: K1/K2 launched %r in %d natgrad steps" % (name, launches, SVGP_STEPS))
        rate = SVGP_STEPS / seconds
        print("svgp path: %s n=%d m=%d minibatch=%d block steps=%d seconds=%.3f steps_per_s=%.1f "
              "examples_per_s=%.0f objective_per_point first50=%.4f last50=%.4f launches %s "
              "per_step K1=%.3f K2=%.3f"
              % (name, SVGP_N, SVGP_M, MINIBATCH, SVGP_STEPS, seconds, rate, rate * MINIBATCH,
                 first, last, " ".join("%s=%d" % kv for kv in sorted(launches.items())),
                 launches["K1"] / SVGP_STEPS, launches["K2"] / SVGP_STEPS))
        busy = profile_window(torch, hb, "svgp " + name, opt, SLICE_PROFILE_STEPS, **kw)
        out[name] = {"steps_per_s": rate, "busy": busy, "launches": launches}
        if natgrad:
            natgrad_checks(torch, hb, data, name)
    return out


def natgrad_run(torch, hb, data, name, use_kernels=True, dtype=None, steps=CHECK_STEPS):
    """A fresh model of an SVGP pairing, `steps` steps from the same weights
    and rows; returns (history, model, optimizer)."""
    family, method, analytic_kl, make_opt = SVGP_PAIRINGS[name]
    cfg = settings_with(hb, use_kernels=use_kernels)
    if dtype is not None:
        cfg.dtypes.float_type = dtype
    with hb.settings.temp_settings(cfg):
        m = svgp_model(hb, data, family, analytic_kl)
        o = getattr(m, method)().compile(make_opt(hb, m))
        if not steps:
            return None, None, m, o
        hist, _, launches = run_path(torch, hb, o, steps, minibatch_size=MINIBATCH,
                                     minibatch_mode="block")
    return hist.astype(np.float64), launches, m, o


def natgrad_checks(torch, hb, data, name):
    """For a natural-gradient SVGP pairing, against float64 as the arbiter:
    the natural step at m = 128 is a solve with Sigma^-1, whose condition
    number at this likelihood scale (n / B = 977) puts float32's error far
    above 1e-4 on any float32 path (measured: two float32 paths 3e-3 apart
    in 20 steps, each as far from float64). So CHECK_STEPS steps with the
    kernels and as many with use_kernels off (no kernel may launch) are
    both held to a float64 run from the same weights and rows: the
    kernels' largest deviation at most NATGRAD_F32_FACTOR times the
    library path's, plus 1e-4 of the objective's scale. Then the first
    update from the initial weights and the same gradients on the card
    (K1, K2), on the CPU in float32 (plain versions) and on the CPU in
    float64: each leaf's card error against float64 at most
    NATGRAD_F32_FACTOR times the CPU float32 error, plus 1e-4 of the
    leaf's largest entry; and the operands of that update's K1 and K2
    calls held to the plain versions (natgrad_operand_checks)."""
    from henbun_tpu_torch import optimizers

    on, _, _, _ = natgrad_run(torch, hb, data, name)
    off, launches, _, _ = natgrad_run(torch, hb, data, name, use_kernels=False)
    check(sum(launches.values()) == 0, "svgp %s: use_kernels off launched %r" % (name, launches))
    f64, _, _, _ = natgrad_run(torch, hb, data, name, use_kernels=False, dtype=torch.float64)
    scale = np.abs(f64).max()
    dev_on, dev_off = np.abs(on - f64).max() / scale, np.abs(off - f64).max() / scale
    check(np.isfinite(on).all() and dev_on <= NATGRAD_F32_FACTOR * dev_off + 1e-4,
          "svgp %s: the kernels' objective deviates %g of its scale from float64, the "
          "library's %g" % (name, dev_on, dev_off))

    _, _, model, opt = natgrad_run(torch, hb, data, name, steps=0)
    rows = torch.arange(MINIBATCH, device=model.device)
    val, _ = opt._evaluate_core_aux(opt._trainable, opt._frozen,
                                    opt._take_rows(opt._data_args(), rows),
                                    model.generator, None)
    (-val).backward()
    ng = opt.torch_optimizer
    steps = {}
    for key, dtype in (("cpu32", torch.float32), ("cpu64", torch.float64)):
        params = {k: v.detach().cpu().to(dtype).requires_grad_(True)
                  for k, v in opt._trainable.items()}
        for k, v in params.items():
            v.grad = opt._trainable[k].grad.detach().cpu().to(dtype)
        optimizers.NaturalGradient(model, params, ng.gamma, lambda p: None, ng.adaptive).step()
        steps[key] = params
    saved_rest, ng.rest = ng.rest, None  # the pairs only: Adam is not under test
    chol_in, solve_in = captured_operands(ng.step)
    ng.rest = saved_rest
    natgrad_operand_checks(torch, name, chol_in, solve_in)
    errs = []
    for k in (k for p in ng.pairs for k in p[:2]):
        want = steps["cpu64"][k].detach()
        leaf = float(want.abs().max())
        e_card = float((opt._trainable[k].detach().cpu().double() - want).abs().max()) / leaf
        e_cpu = float((steps["cpu32"][k].detach().double() - want).abs().max()) / leaf
        check(e_card <= NATGRAD_F32_FACTOR * e_cpu + 1e-4,
              "svgp %s natgrad update: %s card error %g of its scale against float64, the CPU's "
              "float32 %g" % (name, k, e_card, e_cpu))
        errs.append("%s card=%.3g cpu32=%.3g card-cpu32=%.3g" % (
            k, e_card, e_cpu,
            float((opt._trainable[k].detach().cpu() - steps["cpu32"][k].detach()).abs().max())
            / leaf))
    print("natgrad check: %s %d steps, objective's largest deviation from float64 / scale: "
          "kernels %.3g, use_kernels=False %.3g (kernels vs off %.3g); one update against "
          "float64, error / leaf scale: %s"
          % (name, CHECK_STEPS, dev_on, dev_off, np.abs(on - off).max() / scale,
             "; ".join(errs)))


def captured_operands(step):
    """Run `step()` with linalg's Cholesky and triangular-solve dispatch
    recording a copy of each operand; returns ([A], [(L, R, transpose)])."""
    from henbun_tpu_torch.ops import linalg

    chol, solve = linalg._cholesky_dispatch, linalg._tri_solve_dispatch
    chol_in, solve_in = [], []

    def rec_chol(A):
        chol_in.append(A.detach().clone())
        return chol(A)

    def rec_solve(L, R, transpose):
        solve_in.append((L.detach().clone(), R.detach().clone(), transpose))
        return solve(L, R, transpose)

    linalg._cholesky_dispatch, linalg._tri_solve_dispatch = rec_chol, rec_solve
    try:
        step()
    finally:
        linalg._cholesky_dispatch, linalg._tri_solve_dispatch = chol, solve
    return chol_in, solve_in


def gamma_n(k):
    """Higham's gamma_k = k u / (1 - k u) for float32."""
    return k * U32 / (1 - k * U32)


def ratio_to(torch, err, scale):
    """Largest err / scale per matrix, inf where scale is 0 and err is not."""
    r = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                    torch.where(err > 0, float("inf"), 0.0))
    return r.flatten(-2).amax(-1)


def same_failures(torch, got, want, what):
    fg = torch.isfinite(got).flatten(-2).all(-1)
    fw = torch.isfinite(want).flatten(-2).all(-1)
    check(torch.equal(fg, fw), "%s: the kernel fails on matrices %s, the plain version on %s"
          % (what, fg.logical_not().nonzero().flatten().tolist(),
             fw.logical_not().nonzero().flatten().tolist()))
    return fw


def chol_operand_check(torch, A, what):
    """K1 against its plain version on the operand A [B, n, n] of a real
    natural step (ill-conditioned: the posterior precision at n / B = 977).
    Both must fail on the same matrices. On the others, each factor must
    meet the backward-error bound of any float32 Cholesky (Higham, Thm
    10.3): |tril(A - L L^T)| <= gamma_{n+1} |L| |L|^T elementwise, which
    no condition number enters. The two factors may then differ by as much
    as A's conditioning lets two such backward errors move the factor, to
    first order (Sun 1991): ||L_k - L_p||_F / ||L||_2 <= kappa_2(A)
    (eta_k + eta_p), eta = ||A - L L^T||_F / ||A||_2 measured, kappa_2
    measured in float64 on the same A."""
    from henbun_tpu_torch.ops import cuda_chol

    n = A.shape[-1]
    Lk = cuda_chol.cholesky128_vbatched(A)
    Lp = cuda_chol.cholesky128_plain(A)
    torch.cuda.synchronize()
    ok = same_failures(torch, Lk, Lp, what)
    if not bool(ok.any()):
        return {"matrices": 0, "failed": int((~ok).sum())}
    A64 = torch.tril(A[ok].double())
    A64 = A64 + torch.tril(A64, -1).mT
    norm_a = torch.linalg.matrix_norm(A64, ord=2)
    back, eta = [], []
    for L in (Lk[ok].double(), Lp[ok].double()):
        res = torch.tril(A64 - L @ L.mT)
        back.append(ratio_to(torch, res.abs(), torch.tril(L.abs() @ L.abs().mT)))
        eta.append(torch.linalg.matrix_norm(res + torch.tril(res, -1).mT) / norm_a)
    kappa = torch.linalg.cond(A64)
    L64 = torch.linalg.cholesky(A64)
    diff = (torch.linalg.matrix_norm(Lk[ok].double() - Lp[ok].double())
            / torch.linalg.matrix_norm(L64, ord=2))
    tol = kappa * (eta[0] + eta[1])
    g = gamma_n(n + 1)
    check(float(back[0].max()) <= g and float(back[1].max()) <= g,
          "%s: backward error / (|L||L^T|) kernel %g, plain %g, bound gamma_%d = %g"
          % (what, float(back[0].max()), float(back[1].max()), n + 1, g))
    check(bool((diff <= tol).all()),
          "%s: ||L_k - L_p||_F / ||L||_2 = %s above kappa_2 (eta_k + eta_p) = %s"
          % (what, diff.tolist(), tol.tolist()))
    return {"matrices": int(ok.sum()), "failed": int((~ok).sum()),
            "kappa": float(kappa.max()), "back_k": float(back[0].max()) / g,
            "back_p": float(back[1].max()) / g, "diff": float(diff.max()),
            "tol": float(tol[diff.argmax()]),
            "vs64": float((torch.linalg.matrix_norm(Lk[ok].double() - L64)
                           / torch.linalg.matrix_norm(L64, ord=2)).max())}


def solve_operand_check(torch, L, R, what):
    """K2 against its plain version on the operands of L X = R of a real
    natural step. Both must fail on the same matrices. On the others, each
    solution must meet the backward-error bound of any float32 substitution
    (Higham, Thm 8.5): |R - tril(L) X| <= gamma_n |tril(L)| |X|
    elementwise, no condition number in it. The two may then differ, to
    first order, by 2 gamma_n cond(L, X) of ||X||_inf, with Skeel's
    condition number cond(L, X) = || |L^-1| |L| |X| ||_inf / ||X||_inf
    measured in float64 on the same L and R."""
    from henbun_tpu_torch.ops import cuda_solve

    n = L.shape[-1]
    Xk = cuda_solve.tri_solve128_vbatched(L, R, False)
    Xp = cuda_solve.tri_solve128_plain(L, R, False)
    torch.cuda.synchronize()
    ok = same_failures(torch, Xk, Xp, what)
    if not bool(ok.any()):
        return {"matrices": 0, "failed": int((~ok).sum())}
    Lt, R64 = torch.tril(L[ok].double()), R[ok].double()
    g = gamma_n(n)
    back = [ratio_to(torch, (R64 - Lt @ X).abs(), Lt.abs() @ X.abs())
            for X in (Xk[ok].double(), Xp[ok].double())]
    X64 = torch.linalg.solve_triangular(Lt, R64, upper=False)
    eye = torch.eye(n, dtype=Lt.dtype, device=Lt.device).expand(Lt.shape)
    Linv = torch.linalg.solve_triangular(Lt, eye, upper=False)
    norm_x = torch.linalg.matrix_norm(X64, ord=float("inf"))
    skeel = torch.linalg.matrix_norm(Linv.abs() @ Lt.abs() @ X64.abs(), ord=float("inf")) / norm_x
    diff = torch.linalg.matrix_norm(Xk[ok].double() - Xp[ok].double(), ord=float("inf")) / norm_x
    tol = 2 * g * skeel
    check(float(back[0].max()) <= g and float(back[1].max()) <= g,
          "%s: backward error / (|L||X|) kernel %g, plain %g, bound gamma_%d = %g"
          % (what, float(back[0].max()), float(back[1].max()), n, g))
    check(bool((diff <= tol).all()),
          "%s: ||X_k - X_p||_inf / ||X||_inf = %s above 2 gamma_n cond(L, X) = %s"
          % (what, diff.tolist(), tol.tolist()))
    return {"matrices": int(ok.sum()), "failed": int((~ok).sum()),
            "kappa": float(torch.linalg.cond(Lt).max()), "skeel": float(skeel.max()),
            "back_k": float(back[0].max()) / g, "back_p": float(back[1].max()) / g,
            "diff": float(diff.max()), "tol": float(tol[diff.argmax()]),
            "vs64": float((torch.linalg.matrix_norm(Xk[ok].double() - X64, ord=float("inf"))
                           / norm_x).max())}


def natgrad_operand_checks(torch, name, chol_in, solve_in):
    """K1 and K2 on the operands one natural step of an SVGP pairing gave
    its two factorizations (Pn + eps I and Sigma_new, [3, m, m] with the
    ladder stacked) and its two inverses (L X = I on the q_sqrt factor and
    on Pn's), each against its plain version (chol_operand_check,
    solve_operand_check)."""
    check(len(chol_in) == 2 and len(solve_in) == 2,
          "svgp %s: a natural step made %d factorizations and %d solves, not 2 and 2"
          % (name, len(chol_in), len(solve_in)))
    rows = []
    for i, A in enumerate(chol_in):
        r = chol_operand_check(torch, A, "svgp %s K1 operand %d" % (name, i))
        rows.append(("K1", i, tuple(A.shape), r))
    for i, (L, R, transpose) in enumerate(solve_in):
        check(not transpose, "svgp %s: natgrad solve %d transposed" % (name, i))
        r = solve_operand_check(torch, L, R, "svgp %s K2 operand %d" % (name, i))
        rows.append(("K2", i, tuple(L.shape), r))
    for k, i, shape, r in rows:
        print("natgrad operands: %s %s %d shape=%s %s" % (
            name, k, i, "x".join(map(str, shape)),
            " ".join("%s=%.4g" % kv for kv in r.items())))


def natgrad_fleet(hb, device=None):
    models = []
    hb.set_seed(0)
    for i in range(FLEET):
        X, Y = robust_toy(N, seed=i)
        models.append(hb.models.GPR(seed=i, X=X, Y=Y, analytic_kl=True, device=device))
    return hb.BatchedOptimizer(models, "ELBO_student_quadrature").compile(
        hb.optimizers.natural_gradient(models[0], gamma=0.2, rest=hb.adam(0.02)))


def natgrad_fleet_phase(torch, hb):
    """16 GPRs (analytic_kl) on ELBO_student_quadrature with
    natural_gradient(0.2, rest=adam(0.02)) (examples/gaussian_process.py,
    batched) on the Laplace fleet's robust data, n = 40: NATGRAD_FLEET_STEPS
    steps with the counts read, the objective finite and rising; then
    CHECK_STEPS steps with the kernels against as many without (1e-4 of the
    objective's scale)."""
    opt = natgrad_fleet(hb)
    hist, seconds, launches = run_path(torch, hb, opt, NATGRAD_FLEET_STEPS)
    first, last = check_rises(hist, "natgrad fleet", 20)
    check(launches["K1"] >= 3 * NATGRAD_FLEET_STEPS and launches["K2"] >= 4 * NATGRAD_FLEET_STEPS,
          "natgrad fleet: launches %r in %d steps" % (launches, NATGRAD_FLEET_STEPS))
    agree = kernels_on_off(torch, hb, "natgrad fleet", lambda: natgrad_fleet(hb))
    rate = NATGRAD_FLEET_STEPS / seconds
    print("natgrad fleet: fleet=%d n=%d ELBO_student_quadrature natgrad(0.2)+adam(0.02) "
          "steps=%d seconds=%.3f steps_per_s=%.1f objective first20=%.3f last20=%.3f launches "
          "%s per_step K1=%.3f K2=%.3f; %s"
          % (FLEET, N, NATGRAD_FLEET_STEPS, seconds, rate, first, last,
             " ".join("%s=%d" % kv for kv in sorted(launches.items())),
             launches["K1"] / NATGRAD_FLEET_STEPS, launches["K2"] / NATGRAD_FLEET_STEPS, agree))
    busy = profile_window(torch, hb, "natgrad fleet", opt, SLICE_PROFILE_STEPS)
    return {"steps_per_s": rate, "busy": busy, "launches": launches}


# ------------------------------------------------- slice 7: EP and sparse evidence
def host_reads(torch, fn):
    """fn() under torch.cuda's sync debug mode: returns (fn's result, the
    number of synchronizing operations it made: host reads of device
    values and device-to-host copies), counted from the mode's warnings."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def leaf_rel(g, ref):
    """{leaf: max |g - ref| over ref's largest entry}."""
    return {k: float(np.abs(g[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}


def held(torch, label, got, want, g64_fn, f32_tol=1e-4, f64_limits=None):
    """Objective values and gradients on the card (`got`: (values, {leaf:
    gradient}), numpy) against a reference's (`want`) at the same weights:
    the values within 1e-4 of the reference's largest, each leaf within
    1e-4 of its largest entry. g64_fn() gives the card's float64 gradients
    (the same code on cuSOLVER and cuBLAS in float64), the arbiter of what
    float32 can hold:
      - f64_limits None: a leaf that misses 1e-4 is arbitrated. Where the
        reference's float32 leaf is within `f32_tol` of float64, the card's
        must be too;
      - f64_limits {leaf: limit}: every leaf of the card is held to float64
        at its limit, each limit set from that path's own readings, whether
        or not it missed the reference.
    Returns a text of the numbers."""
    (v_card, g_card), (v_ref, g_ref) = got, want
    v_card, v_ref = np.asarray(v_card, np.float64), np.asarray(v_ref, np.float64)
    rel = float(np.abs(v_card - v_ref).max() / np.abs(v_ref).max())
    grel = leaf_rel(g_card, g_ref)
    check(rel <= 1e-4, "%s: objective %s / %s (rel %g)" % (label, v_card, v_ref, rel))
    text = "%s: value %srel=%.3g grad_rel %s" % (
        label, "%.6f / %.6f " % (v_card, v_ref) if v_ref.size == 1 else "", rel,
        " ".join("%s=%.3g" % kv for kv in sorted(grel.items())))
    missed = [k for k, r in grel.items() if r > 1e-4]
    if f64_limits is None and not missed:
        return text
    g64 = g64_fn()
    dev_card, dev_ref = leaf_rel(g_card, g64), leaf_rel(g_ref, g64)
    if f64_limits is not None:
        for k in g_ref:
            check(dev_card[k] <= f64_limits[k], "%s: %s gradient %g from float64 (reference %g), "
                  "limit %g" % (label, k, dev_card[k], dev_ref[k], f64_limits[k]))
    else:
        for k in missed:
            if dev_ref[k] <= f32_tol:
                check(dev_card[k] <= f32_tol, "%s: %s gradient card %g (reference %g) from "
                      "float64, tolerance %g" % (label, k, dev_card[k], dev_ref[k], f32_tol))
    return text + "; float32 grad from the card's float64: card %s reference %s (%s)" % (
        " ".join("%s=%.3g" % kv for kv in sorted(dev_card.items())),
        " ".join("%s=%.3g" % kv for kv in sorted(dev_ref.items())),
        "tol %g" % f32_tol if f64_limits is None
        else "limits " + " ".join("%s=%g" % kv for kv in sorted(f64_limits.items())))


def held_to_cpu(torch, hb, label, card_opt, opt_fn, f32_tol=1e-4, f64_limits=None,
                noise=None, rows=None):
    """held() of an Optimizer's objective and gradients on the card against
    the CPU's from the same weights (and injected noise and rows, where
    given). opt_fn(device) builds the Optimizer on `device` under the
    current float type."""
    card = value_and_grad(card_opt, noise, rows)
    t0 = time.perf_counter()
    cpu = value_and_grad(opt_fn("cpu"), noise, rows)
    cpu_s = time.perf_counter() - t0

    def g64_fn():
        cfg = hb.settings.get_settings()
        cfg.dtypes.float_type = torch.float64
        with hb.settings.temp_settings(cfg):
            return value_and_grad(opt_fn("cuda"), noise, rows)[1]

    return held(torch, label + " card vs CPU (CPU %.1f s)" % cpu_s, card, cpu, g64_fn,
                f32_tol, f64_limits)


def fleet_cpu_check(torch, hb, kind, on_card):
    """held_to_cpu for a fleet of `kind` at on_card's weights."""
    method, lr = FLEETS[kind]
    trained = {k: v.detach().cpu() for k, v in on_card._trainable.items()}
    dtype = lambda: hb.settings.dtypes.float_type

    def opt_fn(device):
        models = make_models(hb, device, kind)
        for i, m in enumerate(models):
            m.set_param_dict({k: v[i].to(dtype()) for k, v in trained.items()})
        return hb.BatchedOptimizer(models, method).compile(learning_rate=lr)

    return held_to_cpu(torch, hb, kind + " fleet", on_card, opt_fn,
                       STUDENT_EP_F32_TOL if kind == "ep_gpr" else 1e-4)


def ep_fleet_phase(torch, hb):
    """The EP fleets (benchmarks/laplace_bench.py --engine ep's workload and
    tests/test_ep.py's): 16 robust GPRs on log_marginal_ep_student (n = 40,
    robust_toy data, Adam 0.02, EP_GPR_STEPS steps) and 16 GPCs on
    log_marginal_ep (n = 60, gpc_data, Adam 0.05, EP_GPC_STEPS steps). For
    each: K1 and K2 launches a step (every sweep factors and solves on
    them), host reads a step, the objective finite and rising, ep_delta
    below 1e-2 (GPC); CHECK_STEPS steps with the kernels against as many
    without (1e-4 of the objective's scale), the evidence and gradients on
    the card against the CPU's at the initial weights (held_to_cpu), and
    the fleet's steps/s with the kernels on and off."""
    out = {}
    for kind, steps in (("ep_gpr", EP_GPR_STEPS), ("ep_gpc", EP_GPC_STEPS)):
        t0 = time.perf_counter()
        ref = fleet_cpu_check(torch, hb, kind, make_fleet(hb, "cuda", kind))
        print("  (%s: %.1f s to check against the CPU)" % (kind, time.perf_counter() - t0))
        bo = make_fleet(hb, "cuda", kind)
        hist, seconds, launches = run_path(torch, hb, bo, steps)
        first, last = check_rises(hist, kind + " fleet", 20)
        check(launches["K1"] >= 30 * steps and launches["K2"] >= 30 * steps,
              "%s: K1/K2 launched %r in %d steps" % (kind, launches, steps))
        delta = bo.metrics.rows[-1].get("ep_delta")
        check(delta is not None and delta < 1e-2, "%s: ep_delta %r" % (kind, delta))
        _, reads = host_reads(torch, lambda: bo.optimize(maxiter=READ_STEPS))
        runs, rates = {}, {}
        for use_kernels in (True, False):
            o = make_fleet(hb, "cuda", kind)
            with hb.settings.temp_settings(settings_with(hb, use_kernels=use_kernels)):
                runs[use_kernels], s, ln = run_path(torch, hb, o, CHECK_STEPS)
            if not use_kernels:
                check(sum(ln.values()) == 0, "%s: use_kernels off launched %r" % (kind, ln))
            rates[use_kernels] = CHECK_STEPS / s
        diff = np.abs(runs[True] - runs[False])
        agree = float(diff.max() / np.abs(runs[False]).max())
        check(agree <= 1e-4, "%s kernels vs use_kernels=False: %g of the scale" % (kind, agree))
        print("ep fleet: %s fleet=%d n=%d %s steps=%d seconds=%.3f steps_per_s=%.2f evidence "
              "first20=%.3f last20=%.3f ep_delta=%s launches %s per_step K1=%.2f K2=%.2f "
              "host_reads_per_step=%.2f; %s; "
              "%d steps kernels vs off max_diff/scale=%.3g; steps_per_s kernels_on=%.2f off=%.2f"
              % (kind, FLEET, N if kind == "ep_gpr" else GPC_N, FLEETS[kind][0], steps, seconds,
                 steps / seconds, first, last, "%.3g" % delta if delta is not None else "-",
                 " ".join("%s=%d" % kv for kv in sorted(launches.items())),
                 launches["K1"] / steps, launches["K2"] / steps, reads / READ_STEPS, ref,
                 CHECK_STEPS, agree, rates[True], rates[False]))
        t0 = time.perf_counter()
        busy = busy_window(torch, hb, kind + " fleet", bo, EP_PROFILE_STEPS)
        print("  (%s: traced window and its report %.1f s)" % (kind, time.perf_counter() - t0))
        out[kind] = {"launches": launches, "steps": steps, "steps_per_s": steps / seconds,
                     "reads": reads / READ_STEPS, "busy": busy}
    return out


def sparse_data(n, seed=0):
    """n sorted U[0, 6] rows with Bernoulli labels from sigmoid(3 sin x)
    (test_gpc.py's generator) and Student-t targets sin(x) + 0.2 N(0, 1)
    with 4% of the rows moved by +-4 (test_laplace.py's outlier bed)."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    Yc = (rng.uniform(size=X.shape) < p_true).astype(np.float32)
    Yr = np.sin(X) + rng.normal(size=X.shape).astype(np.float32) * 0.2
    idx = rng.choice(n, n // 25, replace=False)
    Yr[idx] += rng.choice([-4.0, 4.0], len(idx))[:, None]
    return X, Yc, Yr.astype(np.float32)


# name -> (family, objective, steps, model keywords)
SPARSE_RUNS = {
    "SparseGPC laplace": ("gpc", "log_marginal_laplace", 80, {}),
    "SparseGPC ep": ("gpc", "log_marginal_ep", 30, {}),
    "SparseGPRobust laplace": ("robust", "log_marginal_laplace", 100, {}),
    "SparseGPRobust ep (unrolled)": ("robust", "log_marginal_ep", 8, {}),
    "SparseGPC laplace train_z": ("gpc", "log_marginal_laplace", 30, {"train_z": True}),
}


def sparse_model(hb, data, family, device=None, **kw):
    X, Yc, Yr = data
    hb.set_seed(0)
    if family == "gpc":
        return hb.models.SparseGPC(seed=0, X=X, Y=Yc, num_inducing=SPARSE_M, device=device, **kw)
    return hb.models.SparseGPRobust(seed=0, X=X, Y=Yr, num_inducing=SPARSE_M, device=device, **kw)


def sparse_cpu_check(torch, hb, data, name, model, opt):
    """held_to_cpu for a sparse run at the model's (initial) weights."""
    family, method, _, kw = SPARSE_RUNS[name]
    params = {k: v.detach().cpu() for k, v in model.param_dict().items()}

    def opt_fn(device):
        m = sparse_model(hb, data, family, device=device, **kw)
        m.set_param_dict({k: v.to(hb.settings.dtypes.float_type) for k, v in params.items()})
        return getattr(m, method)().compile(learning_rate=0.05)

    tol = SPARSE_EP_F32_TOL if method == "log_marginal_ep" else SPARSE_LAPLACE_F32_TOL
    return "%s; %s" % (sparse_kmm_cond(torch, hb, model),
                       held_to_cpu(torch, hb, name, opt, opt_fn, tol))


def sparse_kmm_cond(torch, hb, model):
    """The 2-norm condition number of Kmm + jitter I at the model's z and
    kernel, with the jitter kern.Cholesky adds (float64)."""
    K = model.run(lambda mm: mm.gp.kern.K(mm.gp.z)).double().cpu()
    m = K.shape[0]
    jitter = hb.settings.numerics.jitter_level * max(1.0, m / 96.0)
    K = K + jitter * torch.eye(m, dtype=K.dtype)
    return "Kmm+jitter cond=%.3g" % float(torch.linalg.cond(K))


def sparse_accuracy(torch, hb, name, model):
    """The JAX tests' accuracy gates after training: mean |p - p_true| <
    0.03 on the grid (test_gpc.py) for the classifier's Laplace fit, RMSE
    against the clean sine < 0.05 (test_laplace.py) for the robust
    Laplace fit; the EP fits' accuracy is printed. A Laplace fit must end
    at a mode (grad_norm < 1)."""
    from henbun_tpu_torch.inference.laplace import laplace_whitened

    grid = np.linspace(0.1, 5.9, 40, dtype=np.float32)[:, None]
    family, method = SPARSE_RUNS[name][:2]
    laplace = method == "log_marginal_laplace"
    if family == "gpc":
        p = model.run(lambda mm: mm.predict_p(grid) if laplace else mm.predict_p_ep(grid))
        truth = 1.0 / (1.0 + np.exp(-3.0 * np.sin(grid[:, 0])))
        err = float(np.abs(p.cpu().numpy()[:, 0] - truth).mean())
        what, gate = "mean|p-p_true|", 0.03
    else:
        mean, var = model.run(lambda mm: mm.predict_f(grid) if laplace else mm.predict_f_ep(grid))
        check(bool((var > 0).all()), "%s: non-positive predictive variance" % name)
        err = float(np.sqrt(np.mean((mean.cpu().numpy()[:, 0] - np.sin(grid[:, 0])) ** 2)))
        what, gate = "rmse", 0.05
    text = "%s=%.4f" % (what, err)
    if laplace:
        check(err < gate, "%s: %s %g, gate %g" % (name, what, err, gate))
        gnorm = float(model.run(lambda mm: laplace_whitened(
            mm._loglik(), mm._A(mm.x), newton_iters=mm._newton_iters,
            fused=mm._fused()).grad_norm))
        check(gnorm < 1, "%s: grad_norm %g after the fit" % (name, gnorm))
        text += " (gate %g) grad_norm=%.3g" % (gate, gnorm)
    return text


def sparse_phase(torch, hb):
    """Sparse evidence at full width (benchmarks/families_bench.py:100-114,
    docs/PERF.md:399-401): n = 1e5 sorted U[0, 6] rows, m = 128, full batch
    on the card, each run of SPARSE_RUNS from its initial weights: the card
    against the CPU there, the objective finite and rising, the accuracy
    gates, steps/s, host reads a step, a traced window's busy share and
    device operations a step, the peak memory. The SparseGPC Laplace run
    saves its training state after RESUME_AT steps for resume_phase."""
    data = sparse_data(SPARSE_N)
    out = {}
    for name, (family, method, steps, kw) in SPARSE_RUNS.items():
        model = sparse_model(hb, data, family, **kw)
        opt = getattr(model, method)().compile(learning_rate=0.05)
        t0 = time.perf_counter()
        ref = sparse_cpu_check(torch, hb, data, name, model, opt)
        check_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        resume = None
        if name == "SparseGPC laplace":
            h1, s1, _ = run_path(torch, hb, opt, RESUME_AT)
            os.makedirs(os.path.dirname(RESUME_PATH), exist_ok=True)
            opt.save_state(RESUME_PATH)
            h2, s2, _ = run_path(torch, hb, opt, RESUME_STEPS)
            resume = {"hist": h2, "params": {k: v.detach().clone()
                                               for k, v in opt._trainable.items()}}
            h3, s3, launches = run_path(torch, hb, opt, steps - RESUME_AT - RESUME_STEPS)
            hist, seconds = np.concatenate([h1, h2, h3]), s1 + s2 + s3
        else:
            hist, seconds, launches = run_path(torch, hb, opt, steps)
        peak = torch.cuda.max_memory_allocated()
        first, last = check_rises(hist / SPARSE_N, name, 10)
        accuracy = sparse_accuracy(torch, hb, name, model)
        if kw.get("train_z"):
            spacing = hb.gp.gp.z_min_spacing(model.gp.z.value)
            check(spacing > 0.5 * model._z_d0, "%s: min z spacing %g below d0/2 = %g"
                  % (name, spacing, 0.5 * model._z_d0))
            accuracy += " min_z_spacing=%.4g d0=%.4g" % (spacing, model._z_d0)
        if method == "log_marginal_ep" and family == "gpc":
            accuracy += " ep_delta=%.3g" % opt.metrics.rows[-1]["ep_delta"]
        _, reads = host_reads(torch, lambda: opt.optimize(maxiter=READ_STEPS))
        rate = steps / seconds
        print("sparse path: %s n=%d m=%d %s steps=%d seconds=%.3f steps_per_s=%.2f "
              "objective_per_point first10=%.5f last10=%.5f host_reads_per_step=%.1f "
              "peak_mem_gib=%.2f launches %s; %s; %s"
              % (name, SPARSE_N, SPARSE_M, method, steps, seconds, rate, first, last,
                 reads / READ_STEPS, peak / 2**30,
                 " ".join("%s=%d" % kv for kv in sorted(launches.items())), accuracy, ref))
        t0 = time.perf_counter()
        traced = UNROLLED_PROFILE_STEPS if name == "SparseGPRobust ep (unrolled)" else SPARSE_PROFILE_STEPS
        busy = busy_window(torch, hb, "sparse " + name, opt, traced)
        print("  (%s: %.1f s to check against the CPU, %.1f s traced window and its report)"
              % (name, check_s, time.perf_counter() - t0))
        out[name] = {"steps_per_s": rate, "busy": busy, "reads": reads / READ_STEPS,
                     "peak": peak, "resume": resume}
    return out


def sparse_fleet_phase(torch, hb):
    """16 SparseGPCs at n = 96, m = 24 (the rectangular shape the kernel
    phase checks K3 at) on the Laplace evidence, Adam 0.05,
    SPARSE_FLEET_STEPS steps: K3 once a step, K1 and K2 counted; then
    CHECK_STEPS steps with the kernels against as many without (1e-4 of
    the evidence's scale)."""
    opt = make_fleet(hb, "cuda", "sparse")
    hist, seconds, launches = run_path(torch, hb, opt, SPARSE_FLEET_STEPS)
    first, last = check_rises(hist, "sparse fleet", 20)
    check(launches["K3"] == SPARSE_FLEET_STEPS,
          "sparse fleet: K3 launched %d times in %d steps" % (launches["K3"], SPARSE_FLEET_STEPS))
    check(launches["K1"] > 0 and launches["K2"] > 0, "sparse fleet: launches %r" % launches)
    _, reads = host_reads(torch, lambda: opt.optimize(maxiter=READ_STEPS))
    runs = {}
    for use_kernels in (True, False):
        o = make_fleet(hb, "cuda", "sparse")
        with hb.settings.temp_settings(settings_with(hb, use_kernels=use_kernels)):
            runs[use_kernels], _, ln = run_path(torch, hb, o, CHECK_STEPS)
        if not use_kernels:
            check(sum(ln.values()) == 0, "sparse fleet: use_kernels off launched %r" % ln)
    diff = np.abs(runs[True] - runs[False])
    agree = float(diff.max() / np.abs(runs[False]).max())
    check(agree <= 1e-4, "sparse fleet kernels vs use_kernels=False: %g of the scale" % agree)
    rate = SPARSE_FLEET_STEPS / seconds
    print("sparse fleet: fleet=%d n=%d m=%d log_marginal_laplace steps=%d seconds=%.3f "
          "steps_per_s=%.2f evidence first20=%.3f last20=%.3f launches %s per_step K1=%.2f "
          "K2=%.2f K3=%.2f host_reads_per_step=%.1f; %d steps kernels vs off max_diff/scale=%.3g"
          % (FLEET, SPARSE_FLEET_N, SPARSE_FLEET_M, SPARSE_FLEET_STEPS, seconds, rate, first, last,
             " ".join("%s=%d" % kv for kv in sorted(launches.items())),
             launches["K1"] / SPARSE_FLEET_STEPS, launches["K2"] / SPARSE_FLEET_STEPS,
             launches["K3"] / SPARSE_FLEET_STEPS, reads / READ_STEPS, CHECK_STEPS, agree))
    busy = busy_window(torch, hb, "sparse fleet", opt, SLICE_PROFILE_STEPS)
    return {"launches": launches, "steps_per_s": rate, "reads": reads / READ_STEPS, "busy": busy}


def resume_phase(torch, hb, resume):
    """restore_state of the training state sparse_phase saved after
    RESUME_AT steps of the SparseGPC Laplace run into a fresh model and
    optimizer, then RESUME_STEPS steps: the objectives and parameters
    within 1e-6 relative of the run that went on from the save; prints
    whether they are bitwise equal."""
    model = sparse_model(hb, sparse_data(SPARSE_N), "gpc")
    opt = model.log_marginal_laplace().compile(learning_rate=0.05)
    opt.restore_state(RESUME_PATH)
    check(opt.global_step == RESUME_AT, "restored global_step %d" % opt.global_step)
    hist, _, _ = run_path(torch, hb, opt, RESUME_STEPS)
    h_rel = float(np.abs(hist - resume["hist"]).max() / np.abs(resume["hist"]).max())
    p_rel = max(float(((opt._trainable[k] - v).abs().max() / v.abs().max()).item())
                for k, v in resume["params"].items())
    bitwise = bool(np.array_equal(hist, resume["hist"])) and all(
        torch.equal(opt._trainable[k], v) for k, v in resume["params"].items())
    check(h_rel <= 1e-6 and p_rel <= 1e-6,
          "resume: objective rel %g, parameters rel %g after %d steps" % (h_rel, p_rel, RESUME_STEPS))
    print("resume: SparseGPC laplace n=%d m=%d save_state after %d steps, restore_state into a "
          "fresh optimizer, %d steps each way: objective max rel %.3g parameters max rel %.3g "
          "bitwise_equal=%s" % (SPARSE_N, SPARSE_M, RESUME_AT, RESUME_STEPS, h_rel, p_rel, bitwise))


# ------------------------------- slice 8: the multiclass engine and the samplers
MC_N, MC_M, MC_K = 100_000, 128, 3
MC_STEPS = 100
MC_PROFILE_STEPS = 3
MC_GRID_GATE = 0.02        # mean |p - p_true| on the grid (test_multiclass_oracle.py)
MC_KV_STRESS = 100.0       # n k_var = 1e7: the CholQR2 first-pass shift question
SAMPLER_CHAINS = 256
SAMPLER_ITERS = {"hmc": (200, 200), "chees": (100, 100), "nuts": (30, 30)}
TRACE_ITERS = 2            # warmup and sampling iterations of a traced sampler call
GAUSS_DIM = 50
GAUSS_ITERS = (200, 200)
# the JAX tests' limits on the largest |mean| and |np.cov - cov|
# (tests/test_hmc.py:16, tests/test_chees.py:12, tests/test_nuts_smc.py:16)
GAUSS_GATES = {"hmc": (0.15, 0.35), "chees": (0.12, 0.3), "nuts": (0.15, 0.35)}
GAUSS_Z = 6.0              # and within this many of the run's Monte Carlo standard errors
BAYES_N, BAYES_M, BAYES_CHAINS = 20_000, 32, 8
BAYES_ITERS = (50, 50)     # the reference ran 300 + 300; cut (100 + 100 before phase 28)
SMC_GRID, SMC_PARTICLES, SMC_NOISE = 8, 8192, 0.1
SMC_MEAN_GATE = 0.005
# the card's float32 gradient against its float64 one, a limit for each
# leaf at 3.5-4.6x that path's reading (H100 80GB HBM3, 700 W; the CPU's
# float32 reading in brackets): multiclass at n = 1e5, m = 128 lengthscale
# 1.39e-3 (1.08e-3), k_var 1.09e-5 (1.86e-3); the Bayes path's 8 chains at
# n = 2e4, m = 32 lengthscale 5.13e-4 (2.12e-4), k_var 5.73e-5 (2.86e-5).
# A TF32 product (~1e-3 relative) anywhere on either path breaks k_var's
MC_F64_LIMITS = {"gp.kern.lengthscales": 5e-3, "k_var": 5e-5}
BAYES_F64_LIMITS = {"gp.kern.lengthscales": 2e-3, "k_var": 2e-4}


def three_sines(x, K=MC_K):
    """benchmarks/multiclass_scale_bench.py's class probabilities at x."""
    F = np.stack([3.0 * np.sin(x), 2.0 * np.cos(0.7 * x), 1.5 * np.sin(1.3 * x + 1.0)][:K],
                 axis=-1)
    P = np.exp(F - F.max(axis=1, keepdims=True))
    return P / P.sum(axis=1, keepdims=True)


def multiclass_data(n):
    """benchmarks/multiclass_scale_bench.py's rows: n sorted U[0, 6] inputs,
    labels drawn from the three-sine softmax."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    P = three_sines(X[:, 0])
    y = np.array([rng.choice(MC_K, p=p) for p in P], np.int32)[:, None]
    return X, y


def multiclass_model(hb, X, y, device=None):
    hb.set_seed(0)
    return hb.models.SparseGPMulticlass(seed=0, X=X, Y=y, num_classes=MC_K,
                                        num_inducing=MC_M, device=device)


def sqrt_factor_checks(torch, hb, model):
    """The CholQR2 logdet and one H-solve at the model's mode against the
    float64 evaluation of the same G on the card (the JAX package's
    test_sqrt_factor.py gates: logdet rtol 1e-4, solve 1e-3)."""
    from henbun_tpu_torch.inference import laplace as lap

    G = model.run(lambda mm: lap._softmax_G(mm._A(mm.x), torch.softmax(mm.laplace().f_mode, -1)))
    R = lap._sqrt_gram_factor(G)
    ld = float(2.0 * torch.sum(torch.log(torch.diagonal(R))))
    G64 = G.double()
    H64 = torch.eye(G.shape[1], dtype=torch.float64, device=G.device) + G64.mT @ G64
    ld64 = float(torch.linalg.slogdet(H64)[1])
    b = torch.randn((G.shape[1], 1), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    x = lap._sqrt_solve(R, b).double()
    x64 = torch.linalg.solve(H64, b.double())
    solve_rel = float(torch.linalg.norm(x - x64) / torch.linalg.norm(x64))
    check(abs(ld - ld64) <= 1e-4 * abs(ld64), "CholQR2 logdet %.6f vs float64 %.6f" % (ld, ld64))
    check(solve_rel <= 1e-3, "CholQR2 H-solve rel err %g from float64" % solve_rel)
    return "logdet f32=%.4f f64=%.4f abs_err=%.3g; H-solve rel err %.3g; lambda_max(H)=%.4g" % (
        ld, ld64, abs(ld - ld64), solve_rel, float(torch.linalg.eigvalsh(H64)[-1]))


def shift_question(torch, hb, X, y):
    """Measure, do not switch: with k_var forced to MC_KV_STRESS (n k_var =
    1e7), factor pass 1 of CholQR2 (I + G^T G, floored by the shift base,
    plus the base as safe_cholesky's first jitter) at the mode with the
    shift base 1e-4 (the engine's) and 1e-6: does the first factorization
    fail (indefinite in float32), and how far is the full factor's logdet
    from float64?"""
    from henbun_tpu_torch.inference import laplace as lap

    m = multiclass_model(hb, X, y, "cuda")
    m.k_var.assign(np.array([MC_KV_STRESS], np.float32))
    m.initialize()
    res = m.run(lambda mm: mm.laplace())
    G = m.run(lambda mm: lap._softmax_G(mm._A(mm.x), torch.softmax(res.f_mode, -1)))
    G64 = G.double()
    p = G.shape[1]
    I = torch.eye(p, device=G.device)
    H64 = torch.eye(p, dtype=torch.float64, device=G.device) + G64.mT @ G64
    ld64 = float(torch.linalg.slogdet(H64)[1])
    out = ["n*k_var=%.3g grad_norm=%.3g lambda_max(H)=%.4g" % (
        MC_N * MC_KV_STRESS, float(res.grad_norm), float(torch.linalg.eigvalsh(H64)[-1]))]
    for base in (1e-4, 1e-6):
        B0 = lap._with_floor(I + G.mT @ G, base)
        _, info = torch.linalg.cholesky_ex(B0 + base * I)
        min_eig = float(torch.linalg.eigvalsh(B0.double())[0])
        R = lap._sqrt_gram_factor(G, base)
        ld = float(2.0 * torch.sum(torch.log(torch.diagonal(R))))
        out.append("shift %g: pass1 %s (float32 min eig of floored B0 %.4g) logdet err %.3g"
                   % (base, "INDEFINITE" if int(info) > 0 else "clean", min_eig, abs(ld - ld64)))
    return "; ".join(out)


def multiclass_phase(torch, hb):
    """benchmarks/multiclass_scale_bench.py's workload: SparseGPMulticlass
    at n = 1e5, m = 128, K = 3, full batch, Adam 0.05, MC_STEPS steps. The
    evidence and its gradient at the initial weights card vs CPU
    (held_to_cpu, every leaf held to float64 at MC_F64_LIMITS), the CholQR2
    factor against float64, finite and rising
    evidence, the grid probabilities against the generator, steps/s, host
    reads a step, a traced window, peak memory, and the shift question."""
    X, y = multiclass_data(MC_N)
    model = multiclass_model(hb, X, y, "cuda")
    opt = model.log_marginal_laplace().compile(learning_rate=0.05)
    params = {k: v.detach().cpu() for k, v in model.param_dict().items()}

    def opt_fn(device):
        m = multiclass_model(hb, X, y, device)
        m.set_param_dict({k: v.to(hb.settings.dtypes.float_type) for k, v in params.items()})
        return m.log_marginal_laplace().compile(learning_rate=0.05)

    t0 = time.perf_counter()
    ref = held_to_cpu(torch, hb, "multiclass", opt, opt_fn, f64_limits=MC_F64_LIMITS)
    check_s = time.perf_counter() - t0
    factor = sqrt_factor_checks(torch, hb, model)
    torch.cuda.reset_peak_memory_stats()
    hist, seconds, launches = run_path(torch, hb, opt, MC_STEPS)
    peak = torch.cuda.max_memory_allocated()
    first, last = check_rises(hist / MC_N, "multiclass", 10)
    grid = np.linspace(0.1, 5.9, 60, dtype=np.float32)[:, None]
    p_hat = model.run(lambda mm: mm.predict_p(grid)).cpu().numpy()
    err = float(np.abs(p_hat - three_sines(grid[:, 0])).mean())
    check(np.isfinite(p_hat).all() and err < MC_GRID_GATE,
          "multiclass: grid mean |p - p_true| %g, gate %g" % (err, MC_GRID_GATE))
    gnorm = float(model.run(lambda mm: mm.laplace().grad_norm))
    check(gnorm < 1, "multiclass: grad_norm %g after the fit" % gnorm)
    _, reads = host_reads(torch, lambda: opt.optimize(maxiter=READ_STEPS))
    kv = float(model.k_var.value[0])
    print("multiclass path: n=%d m=%d K=%d steps=%d seconds=%.3f steps_per_s=%.3f "
          "evidence_per_point first10=%.5f last10=%.5f k_var=%.4f n*k_var=%.3g grid_mean_abs_err=%.4f "
          "(gate %g) grad_norm=%.3g host_reads_per_step=%.1f peak_mem_gib=%.2f launches %s; %s "
          "(CPU check %.1f s); %s"
          % (MC_N, MC_M, MC_K, MC_STEPS, seconds, MC_STEPS / seconds, first, last, kv, MC_N * kv,
             err, MC_GRID_GATE, gnorm, reads / READ_STEPS, peak / 2**30,
             " ".join("%s=%d" % kv_ for kv_ in sorted(launches.items())), ref, check_s, factor))
    busy = busy_window(torch, hb, "multiclass", opt, MC_PROFILE_STEPS)
    print("multiclass shift question: " + shift_question(torch, hb, X, y))
    return {"steps_per_s": MC_STEPS / seconds, "busy": busy, "reads": reads / READ_STEPS,
            "peak": peak}


def traced_call(torch, fn):
    """fn() under torch.profiler (card activity only): (device operations,
    busy share of the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(torch, prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return len(events), busy_ms / wall_ms


def gaussian_target(torch, dim, device="cuda"):
    """A correlated Gaussian: AR(1) correlation 0.5, scales 0.7 to 1.4."""
    s = np.linspace(0.7, 1.4, dim)
    idx = np.arange(dim)
    cov = 0.5 ** np.abs(idx[:, None] - idx[None, :]) * s[:, None] * s[None, :]
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)
    return (lambda t: -0.5 * t @ prec @ t), cov


def gaussian_check(torch, name, mod, device="cuda"):
    """Each sampler on a GAUSS_DIM-dim correlated Gaussian with
    SAMPLER_CHAINS chains: the largest mean and covariance errors within the
    JAX tests' limits (GAUSS_GATES, their atol on np.cov) and within
    GAUSS_Z Monte Carlo standard errors of this run (each mean's from its
    bulk ESS, each covariance entry's from the smallest bulk ESS of the
    centred squares); accept rate in (0.5, 0.95)."""
    from henbun_tpu_torch.inference import diagnostics

    lp, cov = gaussian_target(torch, GAUSS_DIM, device)
    g = torch.Generator(device=device).manual_seed(1)
    init = torch.randn((SAMPLER_CHAINS, GAUSS_DIM), generator=g, device=device)
    warm, samp = GAUSS_ITERS
    res = mod.sample(lp, init, g, num_samples=samp, num_warmup=warm)
    draws = res.samples.double().cpu().numpy()  # [samples, chains, dim]
    x = draws.reshape(-1, GAUSS_DIM)
    mean, emp = x.mean(0), np.cov(x.T)
    ess = diagnostics.ess_bulk(draws)
    ess2 = float(diagnostics.ess_bulk((draws - mean) ** 2).min())
    var = np.diag(cov)
    mean_z = float((np.abs(mean) / np.sqrt(var / ess)).max())
    cov_z = float((np.abs(emp - cov) / np.sqrt((np.outer(var, var) + cov**2) / ess2)).max())
    mean_err, cov_err = float(np.abs(mean).max()), float(np.abs(emp - cov).max())
    mean_tol, cov_tol = GAUSS_GATES[name]
    acc = float(res.accept_prob.mean())
    check(mean_err < mean_tol and cov_err < cov_tol and max(mean_z, cov_z) < GAUSS_Z
          and 0.5 < acc < 0.95,
          "%s on the %d-dim Gaussian: max |mean| %g (tol %g, %.2f se), max |cov err| %g "
          "(tol %g, %.2f se; gate %g se), accept %g"
          % (name, GAUSS_DIM, mean_err, mean_tol, mean_z, cov_err, cov_tol, cov_z, GAUSS_Z, acc))
    return ("gaussian%d max|mean|=%.4f (%.2f se) max|cov_err|=%.4f (%.2f se) max|var_err|=%.4f "
            "ess_bulk min=%.0f second-moment ess min=%.0f accept=%.3f"
            % (GAUSS_DIM, mean_err, mean_z, cov_err, cov_z, float(np.abs(np.diag(emp) - var).max()),
               ess.min(), ess2, acc))


def sampler_phase(torch, hb):
    """BASELINE config 4 (benchmarks/ess_bench.py's workload): BNN(hidden=16)
    on make_bnn_dataset(n=128), 49 dimensions, SAMPLER_CHAINS chains from
    the initial weights plus 0.1 N(0, 1): HMC, ChEES and NUTS with
    SAMPLER_ITERS warmup and sampling iterations each, the gradient
    evaluations replayed from CUDA graphs (the target never synchronizes,
    so logprob.CudaGraphed captures it; the graphed evaluation is first
    held to the eager one and both are timed).
    Min and median bulk ESS/s, accept rate, wall time, leapfrogs an
    iteration (NUTS: the depths reached), device operations and host reads
    an iteration (a short traced call and a short call in sync debug
    mode); finite step size and trajectory; each sampler also on a
    correlated Gaussian."""
    from henbun_tpu_torch.inference import chees, diagnostics, hmc, logprob, nuts

    hb.set_seed(0)
    X, Y = hb.models.make_bnn_dataset(n=128)
    model = hb.models.BNN(seed=0, X=X, Y=Y, hidden=16, device="cuda")
    flp = logprob.make_log_prob(model, "log_posterior")
    check(flp.dim == 49, "BNN(hidden=16) has %d dimensions, not 49" % flp.dim)
    g = torch.Generator(device="cuda").manual_seed(0)
    init = flp.initial + 0.1 * torch.randn((SAMPLER_CHAINS, flp.dim), generator=g, device="cuda")
    graphed = logprob.batched_value_and_grad(flp.log_prob)
    eager = graphed.fn
    diff = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(graphed(init), eager(init)))
    check(graphed.graphed, "the BNN target was not captured: it synchronizes the host")
    check(diff <= 1e-5, "graphed BNN log_prob/gradient %g from the eager one" % diff)
    eager_ms, graphed_ms = time_ms(torch, lambda: eager(init)), time_ms(torch, lambda: graphed(init))
    _, eager_reads = host_reads(torch, lambda: eager(init))
    print("sampler evaluation: BNN log_prob + gradient of %d chains eager %.3f ms (%d host reads) "
          "graphed %.3f ms, graphed vs eager max rel %.3g"
          % (SAMPLER_CHAINS, eager_ms, eager_reads, graphed_ms, diff))
    out = {}
    for name, mod in (("hmc", hmc), ("chees", chees), ("nuts", nuts)):
        warm, samp = SAMPLER_ITERS[name]
        replays = logprob.CudaGraphed.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.sample(flp.log_prob, init, g, num_samples=samp, num_warmup=warm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leapfrogs = (logprob.CudaGraphed.replays - replays - 1) / (warm + samp)
        short = lambda: mod.sample(flp.log_prob, init, g, num_samples=TRACE_ITERS,
                                   num_warmup=TRACE_ITERS)
        ops, busy = traced_call(torch, short)
        _, reads = host_reads(torch, short)
        gauss = gaussian_check(torch, name, mod)
        flat = res.samples.cpu().numpy()
        check(np.isfinite(flat).all(), "%s: non-finite samples on the BNN" % name)
        check(bool(torch.isfinite(res.step_size).all()), "%s: step size not finite" % name)
        summ = diagnostics.summarize(flat, accept_prob=res.accept_prob.cpu().numpy())
        ess = diagnostics.ess_bulk(flat)
        ess_geyer = diagnostics.effective_sample_size(flat)
        if name == "chees":
            traj = float(res.trajectory_length)
            check(np.isfinite(traj), "chees: trajectory length not finite")
            extra = " step_size=%.4g trajectory_length=%.4g" % (float(res.step_size), traj)
        elif name == "nuts":
            steps = res.num_steps.cpu().numpy()
            depth = np.ceil(np.log2(steps + 1.0))
            lock = np.max(steps, axis=1)  # the lockstep cost of each sampling iteration
            extra = (" sampling leapfrogs a chain mean=%.1f max=%d; depth reached mean=%.2f max=%d; "
                     "lockstep (deepest chain) leapfrogs an iteration mean=%.1f"
                     % (steps.mean(), steps.max(), depth.mean(), depth.max(), lock.mean()))
        else:
            extra = " step_size median=%.4g" % float(res.step_size.median())
        print("sampler path: %s bnn dim=%d chains=%d warmup=%d samples=%d wall_s=%.3f "
              "ess_bulk min=%.1f median=%.1f -> min_ess_per_s=%.2f median_ess_per_s=%.2f "
              "geyer_min_ess_per_s=%.2f rhat_max=%.4f accept=%.3f divergences=%d "
              "leapfrogs_per_iteration=%.2f ms_per_leapfrog=%.3f (first %d iterations: "
              "device_ops_per_iteration=%.0f busy_share=%.4f host_reads_per_iteration=%.2f)%s; %s"
              % (name, flp.dim, SAMPLER_CHAINS, warm, samp, wall, ess.min(), np.median(ess),
                 ess.min() / wall, np.median(ess) / wall, ess_geyer.min() / wall,
                 summ["rhat_max"], summ["accept_mean"], summ["divergences"], leapfrogs,
                 1e3 * wall / max(leapfrogs * (warm + samp), 1), 2 * TRACE_ITERS,
                 ops / (2 * TRACE_ITERS), busy, reads / (2 * TRACE_ITERS), extra, gauss))
        out[name] = {"wall": wall, "min_ess_per_s": ess.min() / wall, "accept": summ["accept_mean"],
                     "leapfrogs": leapfrogs}
    return out


def bayes_data(n):
    """examples/bayes_hypers_sparse.py's rows: sorted U[0, 6], labels from
    sigmoid(3 sin x)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (n, 1))).astype(np.float32)
    p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(X)))
    return X, (rng.uniform(size=X.shape) < p_true).astype(np.float32)


def bayes_flp(hb, X, Y, device, params=None):
    from henbun_tpu_torch.inference import logprob

    m = hb.models.SparseGPC(seed=1, X=X, Y=Y, num_inducing=BAYES_M, device=device)
    if params is not None:
        m.set_param_dict({k: v.to(hb.settings.dtypes.float_type) for k, v in params.items()})
    return m, logprob.make_log_prob(m, "log_posterior", hb.graph_key.VARIABLES)


def theta_leaves(flp, values, grads):
    """A batched (log_prob [C], gradient [C, dim]) as held()'s (values,
    {path: gradient columns}), numpy float64."""
    g = grads.detach().double().cpu().numpy()
    out, off = {}, 0
    for path, shape in zip(flp.paths, flp.shapes):
        size = int(np.prod(shape))
        out[path] = g[:, off:off + size]
        off += size
    return values.detach().double().cpu().numpy(), out


def bayes_phase(torch, hb):
    """Bayesian hyperparameters (examples/bayes_hypers_sparse.py at
    docs/PERF.md:436's width): SparseGPC log_posterior at n = 2e4, m = 32,
    BAYES_CHAINS ChEES chains through sample_posterior. K1 and K2 launches
    a gradient evaluation (the 8 chains' vmapped evidence: every Newton
    iteration's factor and the Kmm factor on K1, the IFT's solves on K2)
    and an iteration; the vmapped log_prob and its gradient at one theta
    card vs CPU and kernels on vs off (each gradient leaf held to the
    card's float64 at BAYES_F64_LIMITS); ESS/s, R-hat, the posterior medians
    and 90% intervals, host reads a leapfrog, busy share."""
    from henbun_tpu_torch.inference import logprob, sample_posterior

    X, Y = bayes_data(BAYES_N)
    model, flp = bayes_flp(hb, X, Y, "cuda")
    params = {k: v.detach().cpu() for k, v in model.param_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    theta = flp.initial + 0.1 * torch.randn((BAYES_CHAINS, flp.dim), generator=g, device="cuda")
    vg = logprob.batched_value_and_grad(flp.log_prob)
    vg(theta)  # warm
    # safe_cholesky's retry flag is a host read: no graph, so the settings
    # below (use_kernels off) take effect at the next evaluation
    check(vg.graphed is False, "bayes: a target that reads the host was captured")
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = vg(theta)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    per_eval = {k: c.launches for k, c in counters.items()}
    check(per_eval["K1"] > 0 and per_eval["K2"] > 0,
          "bayes: K1/K2 launched %r in one gradient evaluation" % per_eval)
    _, reads = host_reads(torch, lambda: vg(theta))
    ops, busy = traced_call(torch, lambda: vg(theta))
    with hb.settings.temp_settings(settings_with(hb, use_kernels=False)):
        off = vg(theta)

    def g64():
        cfg = hb.settings.get_settings()
        cfg.dtypes.float_type = torch.float64
        with hb.settings.temp_settings(cfg):
            _, f64 = bayes_flp(hb, X, Y, "cuda", params)
            return theta_leaves(f64, *logprob.batched_value_and_grad(f64.log_prob)(
                theta.double()))[1]

    _, fcpu = bayes_flp(hb, X, Y, "cpu", params)
    cpu = logprob.batched_value_and_grad(fcpu.log_prob)(theta.cpu())
    card, cpu, off = (theta_leaves(flp, *r) for r in (card, cpu, off))
    text = "; ".join((
        held(torch, "card vs CPU", card, cpu, g64, f64_limits=BAYES_F64_LIMITS),
        held(torch, "kernels on vs off", card, off, g64, f64_limits=BAYES_F64_LIMITS)))
    warm, samp = BAYES_ITERS
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, post, diag = sample_posterior(model, "log_posterior", num_chains=BAYES_CHAINS,
                                       num_samples=samp, num_warmup=warm, sampler="chees",
                                       return_diagnostics=True, generator=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {k: c.launches for k, c in counters.items()}
    check(run["K1"] > 0 and run["K2"] > 0, "bayes: K1/K2 launched %r in the run" % run)
    check(bool(torch.isfinite(res.samples).all()), "bayes: non-finite samples")
    acc = diag["accept_mean"]
    check(0.5 < acc < 0.95, "bayes: accept %g outside (0.5, 0.95)" % acc)
    quant = []
    for path in ("k_var", "gp.kern.lengthscales"):
        lo, med, hi = np.quantile(post[path].reshape(-1), [0.05, 0.5, 0.95])
        quant.append("%s median %.4f 90%% [%.4f, %.4f]" % (path, med, lo, hi))
    iters = warm + samp
    print("bayes path: SparseGPC log_posterior n=%d m=%d chains=%d warmup=%d samples=%d "
          "wall_s=%.3f ess_bulk_min=%.1f -> min_ess_per_s=%.3f rhat_max=%.4f accept=%.3f "
          "divergences=%d step_size=%.4g trajectory_length=%.4g; launches a gradient evaluation "
          "K1=%d K2=%d K3=%d (%.3f s; host reads %d, device ops %d, busy_share %.4f); launches an "
          "iteration K1=%.1f K2=%.1f; %s; %s"
          % (BAYES_N, BAYES_M, BAYES_CHAINS, warm, samp, wall, diag["ess_bulk_min"],
             diag["ess_bulk_min"] / wall, diag["rhat_max"], acc, diag["divergences"],
             float(res.step_size), float(res.trajectory_length), per_eval["K1"], per_eval["K2"],
             per_eval["K3"], vg_s, reads, ops, busy, run["K1"] / iters, run["K2"] / iters,
             "; ".join(quant), text))
    return {"wall": wall, "per_eval": per_eval, "reads": reads, "busy": busy,
            "min_ess_per_s": diag["ess_bulk_min"] / wall}


def projection_matrix(g):
    """examples/smc_tomography.py's rays: row, column and two diagonal-band
    line integrals over a g x g grid."""
    rows = []
    idx = np.arange(g * g).reshape(g, g)
    for i in range(g):
        r = np.zeros(g * g)
        r[idx[i, :]] = 1.0
        rows.append(r)
        c = np.zeros(g * g)
        c[idx[:, i]] = 1.0
        rows.append(c)
    for off in range(-g + 1, g):
        d = np.zeros(g * g)
        d[np.diag(idx, off)] = 1.0
        rows.append(d)
    return np.stack(rows).astype(np.float32)


def smoothness_precision(g, strength=4.0):
    """examples/smc_tomography.py's prior: graph-Laplacian precision + ridge."""
    n = g * g
    L = np.zeros((n, n))
    idx = np.arange(n).reshape(g, g)
    for i in range(g):
        for j in range(g):
            a = idx[i, j]
            for di, dj in ((0, 1), (1, 0)):
                if i + di < g and j + dj < g:
                    b = idx[i + di, j + dj]
                    L[a, a] += 1
                    L[b, b] += 1
                    L[a, b] -= 1
                    L[b, a] -= 1
    return (strength * L + np.eye(n)).astype(np.float32)


def smc_phase(torch, hb):
    """BASELINE config 5 (benchmarks/smc_bench.py): adaptive-tempered SMC on
    the 8 x 8 grid-absorption linear-Gaussian tomography, SMC_PARTICLES
    particles, 5 moves of 8 leapfrogs a stage, step 0.05. Final beta 1,
    the posterior mean within SMC_MEAN_GATE of the analytic posterior's,
    stages/s, stages, log-evidence against the analytic log Z. The
    likelihood's evaluation is captured as a CUDA graph (it never
    synchronizes): held to the eager one and both timed."""
    from henbun_tpu_torch.inference import logprob, smc

    g = SMC_GRID
    rng = np.random.default_rng(0)
    xv, yv = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g))
    truth = np.exp(-((xv - 0.2) ** 2 + (yv + 0.1) ** 2) / 0.3).ravel().astype(np.float32)
    A = projection_matrix(g)
    y = A @ truth + rng.normal(size=A.shape[0]).astype(np.float32) * SMC_NOISE
    P0 = smoothness_precision(g)
    noise_var = SMC_NOISE**2
    post_mean = np.linalg.solve(P0 + A.T @ A / noise_var, A.T @ y / noise_var)
    # log Z = log E_prior[exp(log_lik)], the prior N(0, P0^-1), the
    # likelihood unnormalized: log N(y; 0, A P0^-1 A^T + s2 I) + (r/2) log(2 pi s2)
    A64, y64 = A.astype(np.float64), y.astype(np.float64)
    S = A64 @ np.linalg.inv(P0.astype(np.float64)) @ A64.T + noise_var * np.eye(len(y))
    r = len(y)
    log_Z = (-0.5 * y64 @ np.linalg.solve(S, y64) - 0.5 * np.linalg.slogdet(S)[1]
             - 0.5 * r * np.log(2 * np.pi) + 0.5 * r * np.log(2 * np.pi * noise_var))
    At, yt, P0t = (torch.tensor(a, device="cuda") for a in (A, y, P0))

    def log_prior(t):
        return -0.5 * t @ P0t @ t

    def log_lik(t):
        return -0.5 * torch.sum((At @ t - yt) ** 2) / noise_var

    Lp = np.linalg.cholesky(np.linalg.inv(P0))
    z = rng.normal(size=(SMC_PARTICLES, g * g)).astype(np.float32)
    particles = torch.tensor(z @ Lp.T.astype(np.float32), device="cuda")
    vg = logprob.batched_value_and_grad(log_lik)
    diff = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(vg(particles), vg.fn(particles)))
    check(vg.graphed, "smc: the likelihood was not captured: it synchronizes the host")
    check(diff <= 1e-5, "smc: graphed likelihood/gradient %g from the eager one" % diff)
    eager_ms, graphed_ms = (time_ms(torch, lambda: f(particles)) for f in (vg.fn, vg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smc.sample(log_prior, log_lik, particles, 1, num_move_steps=5, num_leapfrog=8,
                     step_size=0.05)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    est = res.particles.double().mean(0).cpu().numpy()
    err = float(np.abs(est - post_mean).mean())
    check(float(res.final_beta) > 1.0 - 1e-5, "smc: final beta %g" % float(res.final_beta))
    check(err < SMC_MEAN_GATE, "smc: posterior mean abs err %g, gate %g" % (err, SMC_MEAN_GATE))
    print("smc path: grid=%dx%d particles=%d moves=5x8 stages=%d seconds=%.3f stages_per_s=%.3f "
          "(likelihood + gradient of the particles eager %.3f ms, graphed %.3f ms, graphed vs eager "
          "max rel %.3g) final_beta=%.6f posterior_mean_abs_err=%.5f (gate %g) "
          "log_evidence=%.3f analytic_log_Z=%.3f"
          % (g, g, SMC_PARTICLES, res.num_stages, seconds, res.num_stages / seconds, eager_ms,
             graphed_ms, diff, float(res.final_beta), err, SMC_MEAN_GATE,
             float(res.log_evidence), log_Z))
    return {"stages_per_s": res.num_stages / seconds, "stages": res.num_stages}


# ------------------------------------------------- slice 9: the remaining families
EXPERT_N = 150
EXPERT_INIT_STEPS = 3000   # examples/expert_gpr.py: ELBO_single, Adam(0.01), jitter 3e-4
EXPERT_STEPS = 1000        # the example's main phase runs 10 x 1,000 (cut)
EXPERT_GRID = 25
EXPERT_DRAWS = 30
# the JAX example on the CPU at these step counts (--init-iters 3000
# --rounds 1 --iters 1000) reads a fit RMSE of 0.323 against Y; the card
# is held to it plus a margin for its other noise stream (PERF.md §4)
EXPERT_RMSE_LIMIT = 0.323 + 0.05
# the ELBO's gradient at n = 150 against the card's float64, each leaf's
# limit about 4x the larger of the card's and the CPU's float32 readings
# in a card run of phase 21 (PERF.md, Findings): the short
# expert's gram (lengthscale 0.2 on a 0.013 grid) is near-singular at its
# jitter, so float32 holds its q_s leaves only to ~3e-3 on either device
EXPERT_F64_LIMITS = {
    "k_var": 1e-4, "k_var_r": 2e-4, "var": 1e-4,
    "kern_l.lengthscales": 5e-4, "kern_r.lengthscales": 8e-4, "kern_s.lengthscales": 2e-3,
    "q_l.q_mu": 3e-4, "q_l.q_sqrt": 3e-4, "q_l.scale": 3e-4,
    "q_r.q_mu": 2e-4, "q_r.q_sqrt": 2e-4, "q_r.scale": 2e-4,
    "q_s.q_mu": 9e-3, "q_s.q_sqrt": 1.2e-2, "q_s.scale": 1e-4,
}
HETERO_N = 120
FAMILY_STEPS = 200         # each single-model family run
HETERO_FLEET_STEPS = 200
FAMILY_N = 100_000         # the sparse families (families_bench.py)
FAMILY_M = 64
FAMILY_MB = 512
MO_N = 80
MO_Q = 2
MO_NATGRAD_STEPS = 200
MO_PREDICT = 100
DGP_N = 400
DGP_STEPS = 300
GPLVM_N = 10_000
GPLVM_STEPS = 300
STREAM_N = 1_000_000       # BASELINE config 3's rows
STREAM_MEGA = 2 ** 16
STREAM_STEPS = 500
STREAM_CHUNK = 50          # steps a megabatch: 10 megabatches


def family_run(torch, hb, label, opt, steps, window, **optimize_kw):
    """`steps` steps of a family's path (run_path), finite and rising over
    `window`, then host reads a step and a traced window. Returns
    {steps_per_s, reads, busy, launches}."""
    hist, seconds, launches = run_path(torch, hb, opt, steps, **optimize_kw)
    first, last = check_rises(hist, label, window)
    # host reads of one chunk of READ_STEPS and of one of twice as many:
    # the difference is what a step reads, the rest the chunk's own
    # (nan-guard snapshot, history copy)
    reads = [host_reads(torch, lambda: opt.optimize(maxiter=k * READ_STEPS, **optimize_kw))[1]
             for k in (1, 2)]
    per_step = (reads[1] - reads[0]) / READ_STEPS
    rate = steps / seconds
    print("family path: %s steps=%d seconds=%.3f steps_per_s=%.2f objective first%d=%.3f "
          "last%d=%.3f host_reads_per_step=%.1f (a chunk of %d steps reads %d) launches %s"
          % (label, steps, seconds, rate, window, first, window, last, per_step, READ_STEPS,
             reads[0], " ".join("%s=%d" % kv for kv in sorted(launches.items()))))
    busy = busy_window(torch, hb, label, opt, SLICE_PROFILE_STEPS, **optimize_kw)
    return {"steps_per_s": rate, "reads": per_step, "busy": busy, "launches": launches}


def expert_phase(torch, hb):
    """21 · ExpertGPR, BASELINE config 2 (examples/expert_gpr.py's recipe
    at n = 150): the ELBO and its gradient on the card against the CPU at
    the initial weights under the same injected noise; ELBO_single for
    EXPERT_INIT_STEPS Adam(0.01) steps with jitter_level 3e-4; the mixture
    ELBO for EXPERT_STEPS Adam(0.001) steps; predict_f on a 25-point grid;
    the fit RMSE of the 30-draw mean against Y below EXPERT_RMSE_LIMIT.
    One model: its three [150, 150] factors go to torch.linalg."""
    hb.set_seed(0)
    X, Y = hb.models.make_expert_dataset(n=EXPERT_N)
    model = hb.models.ExpertGPR(seed=0, X=X, Y=Y)
    g = torch.Generator().manual_seed(21)
    noise = {k: torch.randn(EXPERT_N, generator=g) for k in ("q_l", "q_r", "q_s")}
    card = model.ELBO().compile()  # commits the staged initial values
    start = {k: v.detach().cpu() for k, v in model.param_dict().items()}

    def opt_fn(device):
        m = hb.models.ExpertGPR(seed=0, X=X, Y=Y, device=device)
        m.set_param_dict({k: v.to(hb.settings.dtypes.float_type) for k, v in start.items()})
        return m.ELBO().compile()

    ref = held_to_cpu(torch, hb, "expert ELBO", card, opt_fn, noise=noise,
                      f64_limits=EXPERT_F64_LIMITS)
    cfg = hb.settings.get_settings()
    cfg.numerics.jitter_level = 3e-4
    with hb.settings.temp_settings(cfg):
        init = family_run(torch, hb, "expert ELBO_single (jitter 3e-4)",
                          model.ELBO_single().compile(hb.adam(0.01)), EXPERT_INIT_STEPS, 100)
    # compiled again: the mixture starts from the single-GP fit
    main = family_run(torch, hb, "expert ELBO", model.ELBO().compile(hb.adam(0.001)),
                      EXPERT_STEPS, 100)
    grid = np.linspace(-1, 1, EXPERT_GRID, dtype=np.float32)[:, None]
    f_new = model.run(lambda mm: mm.predict_f(grid))
    check(tuple(f_new.shape) == (EXPERT_GRID, 1) and bool(torch.isfinite(f_new).all()),
          "expert predict_f: shape %r or not finite" % (tuple(f_new.shape),))
    draws = model.draws(lambda mm: mm.f_mixture(), EXPERT_DRAWS).cpu().numpy()
    rmse = float(np.sqrt(np.mean((draws.mean(0) - Y) ** 2)))
    check(rmse < EXPERT_RMSE_LIMIT, "expert fit RMSE %.4f >= %.4f" % (rmse, EXPERT_RMSE_LIMIT))
    print("expert: n=%d init %d steps %.2f steps/s (%.1f host reads a step), main %d steps "
          "%.2f steps/s (%.1f host reads a step, busy %.4f); fit RMSE %.4f (limit %.4f); "
          "predict_f %d points finite; %s"
          % (EXPERT_N, EXPERT_INIT_STEPS, init["steps_per_s"], init["reads"], EXPERT_STEPS,
             main["steps_per_s"], main["reads"], main["busy"], rmse, EXPERT_RMSE_LIMIT,
             EXPERT_GRID, ref))
    return {"init": init, "main": main, "rmse": rmse}


def hetero_fleet(hb, device=None):
    hb.set_seed(0)
    models = []
    for i in range(FLEET):
        X, Y, _ = hb.models.make_hetero_dataset(n=HETERO_N, seed=i)
        models.append(hb.models.HeteroscedasticGPR(seed=i, X=X, Y=Y, device=device))
    return models


def kernels_on_off(torch, hb, label, make_opt, **optimize_kw):
    """CHECK_STEPS steps of make_opt() with the kernels and as many with
    use_kernels off (no kernel may launch), from the same weights: within
    1e-4 of the objective's scale. Returns a text."""
    runs = {}
    for use_kernels in (True, False):
        with hb.settings.temp_settings(settings_with(hb, use_kernels=use_kernels)):
            runs[use_kernels], _, ln = run_path(torch, hb, make_opt(), CHECK_STEPS,
                                                **optimize_kw)
        if not use_kernels:
            check(sum(ln.values()) == 0, "%s: use_kernels off launched %r" % (label, ln))
    on, off = runs[True].astype(np.float64), runs[False].astype(np.float64)
    rel = float(np.abs(on - off).max() / np.abs(off).max())
    check(np.isfinite(on).all() and rel <= 1e-4,
          "%s kernels vs use_kernels=False: %g of the scale" % (label, rel))
    return "%d steps kernels vs use_kernels=False max_diff/scale=%.3g" % (CHECK_STEPS, rel)


def hetero_phase(torch, hb):
    """22 · heteroscedastic (benchmarks/families_bench.py's widths): (a) one
    HeteroscedasticGPR, n = 120, fullrank, ELBO_analytic, Adam 0.02
    (torch.linalg); (b) a 16-model fleet of the same
    (make_hetero_dataset(n=120, seed=i)) through BatchedOptimizer: K1 and
    K2 launches a step (both > 0), CHECK_STEPS steps kernels on vs off,
    the fleet objective and gradient card vs CPU; (c) HeteroSVGP, n = 1e5,
    m = 64, minibatches of 512, ELBO_analytic, the ELBO and gradient card
    vs CPU on the same rows. Each run finite and rising."""
    out = {}
    X, Y, _ = hb.models.make_hetero_dataset(n=HETERO_N, seed=0)
    model = hb.models.HeteroscedasticGPR(seed=0, X=X, Y=Y)
    out["single"] = family_run(torch, hb, "hetero single n=120",
                               model.ELBO_analytic().compile(hb.adam(0.02)), FAMILY_STEPS, 30)

    def fleet_opt(device=None, params=None):
        models = hetero_fleet(hb, device)
        if params is not None:
            for i, m in enumerate(models):
                m.set_param_dict({k: v[i].to(hb.settings.dtypes.float_type)
                                  for k, v in params.items()})
        return hb.BatchedOptimizer(models, "ELBO_analytic").compile(hb.adam(0.02))

    bo = fleet_opt()
    start = {k: v.detach().cpu() for k, v in bo._trainable.items()}
    ref = held_to_cpu(torch, hb, "hetero fleet", bo, lambda d: fleet_opt(d, start))
    fleet = family_run(torch, hb, "hetero fleet 16x120", bo, HETERO_FLEET_STEPS, 20)
    per_step = {k: fleet["launches"][k] / HETERO_FLEET_STEPS for k in ("K1", "K2")}
    check(per_step["K1"] > 0 and per_step["K2"] > 0,
          "hetero fleet: K1/K2 launches a step %r" % per_step)
    agree = kernels_on_off(torch, hb, "hetero fleet", fleet_opt)
    print("hetero fleet: launches a step K1=%.2f K2=%.2f; %s; %s"
          % (per_step["K1"], per_step["K2"], agree, ref))
    fleet["per_step"] = per_step
    out["fleet"] = fleet

    Xs, Ys, _ = hb.models.make_hetero_dataset(n=FAMILY_N, seed=0)
    sv = hb.models.HeteroSVGP(seed=0, X=Xs, Y=Ys, num_inducing=FAMILY_M)
    opt = sv.ELBO_analytic().compile(hb.adam(0.02))
    start = {k: v.detach().cpu() for k, v in sv.param_dict().items()}
    rows = np.random.default_rng(22).choice(FAMILY_N, FAMILY_MB, replace=False)

    def sv_opt(device):
        m = hb.models.HeteroSVGP(seed=0, X=Xs, Y=Ys, num_inducing=FAMILY_M, device=device)
        m.set_param_dict({k: v.to(hb.settings.dtypes.float_type) for k, v in start.items()})
        return m.ELBO_analytic().compile()

    ref = held_to_cpu(torch, hb, "HeteroSVGP", opt, sv_opt, rows=rows)
    out["svgp"] = family_run(torch, hb, "HeteroSVGP n=1e5 m=64", opt, FAMILY_STEPS, 30,
                             minibatch_size=FAMILY_MB)
    print("hetero svgp: %s" % ref)
    return out


def mo_natgrad(hb, shared_kernel=True):
    hb.set_seed(0)
    X, Y, _ = hb.models.make_multioutput_dataset(n=MO_N, seed=0)
    m = hb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=MO_Q, shared_kernel=shared_kernel)
    return m.ELBO_analytic().compile(
        hb.optimizers.natural_gradient(m, gamma=0.3, rest=hb.adam(0.02)))


def multioutput_phase(torch, hb):
    """23 · multi-output (families_bench.py's widths): MultiOutputGPR,
    n = 80, P = 3, Q = 2, ELBO_analytic with Adam 0.02 (torch.linalg);
    the same under natural_gradient(0.3, rest=Adam(0.02)), the layered
    node's two pairs stacked with the ladder to [6, 80, 80]: K1 and K2
    launches a step (> 0), CHECK_STEPS steps kernels on vs off;
    per-latent kernels' predict_f at 100 new points through K2 (the
    [2, 80, 100] solve), against the library (1e-4 of the scale), its
    distance from float64 reported;
    MultiOutputSVGP, n = 1e5, Q = 2, m = 64, minibatches of 512."""
    from henbun_tpu_torch.ops import cuda_solve

    out = {}
    X, Y, _ = hb.models.make_multioutput_dataset(n=MO_N, seed=0)
    m = hb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2)
    out["adam"] = family_run(torch, hb, "MultiOutputGPR n=80 adam",
                             m.ELBO_analytic().compile(hb.adam(0.02)), FAMILY_STEPS, 30)
    ng = family_run(torch, hb, "MultiOutputGPR n=80 natgrad(0.3)", mo_natgrad(hb),
                    MO_NATGRAD_STEPS, 20)
    per_step = {k: ng["launches"][k] / MO_NATGRAD_STEPS for k in ("K1", "K2")}
    check(per_step["K1"] > 0 and per_step["K2"] > 0,
          "multi-output natgrad: K1/K2 launches a step %r" % per_step)
    agree = kernels_on_off(torch, hb, "multi-output natgrad", lambda: mo_natgrad(hb))
    print("multi-output natgrad: launches a step K1=%.2f K2=%.2f; %s"
          % (per_step["K1"], per_step["K2"], agree))
    ng["per_step"] = per_step
    out["natgrad"] = ng

    opt = mo_natgrad(hb, shared_kernel=False)
    opt.optimize(maxiter=50)
    x_new = np.linspace(-0.5, 6.5, MO_PREDICT, dtype=np.float32)[:, None]
    preds = {}
    for label, use_kernels, dtype in (("kernels", True, None), ("library", False, None),
                                      ("float64", False, torch.float64)):
        cfg = settings_with(hb, use_kernels=use_kernels)
        model = opt.model
        if dtype is not None:
            cfg.dtypes.float_type = dtype
            with hb.settings.temp_settings(cfg):
                model = hb.models.MultiOutputGPR(seed=0, X=X, Y=Y, Q=2, shared_kernel=False)
                model.set_param_dict({k: v.detach().double()
                                      for k, v in opt.model.param_dict().items()})
        with hb.settings.temp_settings(cfg):
            before = cuda_solve.tri_solve128_vbatched.launches
            mean, var = model.run(lambda mm: mm.predict_f(x_new))
            launched = cuda_solve.tri_solve128_vbatched.launches - before
        preds[label] = (torch.cat([mean, var], 1).double().cpu().numpy(), launched)
    got, k2 = preds["kernels"]
    check(got.shape == (MO_PREDICT, 6) and np.isfinite(got).all() and k2 > 0,
          "per-latent predict_f: shape %r, K2 launches %d" % (got.shape, k2))
    check(preds["library"][1] == 0, "per-latent predict_f: use_kernels off launched K2")
    lib, want = preds["library"][0], preds["float64"][0]
    scale = np.abs(lib).max()
    rel = np.abs(got - lib).max() / scale
    check(rel <= 1e-4, "per-latent predict_f: kernels %g of the scale from the library" % rel)
    dev_k, dev_l = (np.abs(x - want).max() / np.abs(want).max() for x in (got, lib))
    print("multi-output per-latent predict_f: %d points, K2 launches %d, kernels vs library "
          "%.3g of the scale; from float64: kernels %.3g, library %.3g"
          % (MO_PREDICT, k2, rel, dev_k, dev_l))

    Xs, Ys, _ = hb.models.make_multioutput_dataset(n=FAMILY_N, seed=0)
    sv = hb.models.MultiOutputSVGP(seed=0, X=Xs, Y=Ys, Q=2, num_inducing=FAMILY_M)
    out["svgp"] = family_run(torch, hb, "MultiOutputSVGP n=1e5 m=64",
                             sv.ELBO_analytic().compile(hb.adam(0.02)), FAMILY_STEPS, 30,
                             minibatch_size=FAMILY_MB)
    return out


def deep_phase(torch, hb):
    """24 · deep GP and GP-LVM (families_bench.py:55-66): DeepGPRegression,
    n = 400, m = 32, minibatches of 128, the MC ELBO, Adam 0.01; GPLVM,
    n = 1e4, m = 16, hidden 32, minibatches of 256. Finite and rising."""
    hb.set_seed(0)
    X, Y = hb.models.make_step_dataset(n=DGP_N, seed=0)
    dgp = hb.models.DeepGPRegression(seed=0, X=X, Y=Y, num_inducing=32)
    out = {"deepgp": family_run(torch, hb, "DeepGP n=400 m=32",
                                dgp.ELBO().compile(hb.adam(0.01)), DGP_STEPS, 50,
                                minibatch_size=128)}
    Yc, _ = hb.models.make_curve_dataset(n=GPLVM_N, seed=0)
    lvm = hb.models.GPLVM(seed=0, Y=Yc, d_z=1, num_inducing=16, hidden=32)
    out["gplvm"] = family_run(torch, hb, "GPLVM n=1e4 m=16",
                              lvm.ELBO().compile(hb.adam(0.01)), GPLVM_STEPS, 50,
                              minibatch_size=256)
    return out


class RecordingLoader:
    """An OutOfCoreLoader that keeps each megabatch's row ids and, at each
    next(), checks that the device copy of the megabatch it handed out
    before still equals that megabatch bit for bit, though the workers
    have refilled the ring buffer it came from since."""

    def __init__(self, torch, loader, model, id_col):
        self.torch, self.loader, self.model, self.id_col = torch, loader, model, id_col
        self.ids, self.last, self.checked = [], None, 0

    def verify(self):
        if self.last is None:
            return
        dev = self.torch.cat([self.model.x.device_value(), self.model.y.device_value()], 1)
        check(dev.device.type == "cuda", "streamed data is not on the card")
        check(np.array_equal(dev.cpu().numpy(), self.last[:, : self.id_col]),
              "streamed megabatch changed on the card after the loader moved on")
        self.checked += 1

    def next(self):
        self.verify()
        mega = self.loader.next()
        self.ids.append(mega[:, self.id_col].copy().view(np.int32))
        self.last = mega.copy()
        return mega


def streaming_phase(torch, hb, in_core_rate):
    """25 · streaming (BASELINE config 3's model, phase 10's
    AmortizedRegression, d_z = 4, hidden = 64): 1e6 rows with a row-id
    column written by write_dataset to a temporary directory; 500 steps
    through optimize_streaming, megabatches of 2^16 rows, minibatches of
    1,024, STREAM_CHUNK steps a megabatch. Gates: every megabatch row is
    in the train split (test_frac 0, tests/test_io.py:206's check); the
    distinct file rows read match sampling with replacement (within 1%);
    each megabatch's device copy equals what the loader handed out, at
    the next megabatch (RecordingLoader); the objective finite and rising.
    Reports steps/s against phase 10's in-core rate and the busy share."""
    import tempfile

    from henbun_tpu_torch.io import OutOfCoreLoader, optimize_streaming, write_dataset

    X, Y = hb.models.make_synthetic_regression(n=STREAM_N, d_x=8, seed=0)
    ids = np.arange(STREAM_N, dtype=np.int32)[:, None]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.f32")
        t0 = time.perf_counter()
        n, row_floats, slices, _ = write_dataset(path, X, Y, ids)
        write_s = time.perf_counter() - t0
        hb.set_seed(0)
        model = hb.models.AmortizedRegression(seed=0, X=X[:STREAM_MEGA], Y=Y[:STREAM_MEGA],
                                              d_z=4, hidden=64)
        model.n_data = n
        opt = model.ELBO().compile(hb.adam(0.003))
        counters = all_counters()
        with OutOfCoreLoader(path, n, row_floats, batch_rows=STREAM_MEGA, seed=25) as dl, \
                hb.settings.temp_settings(settings_with(hb, scan_chunk=STREAM_CHUNK)):
            rec = RecordingLoader(torch, dl, model, slices[2][0])
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimize_streaming(opt, rec, slices[:2], maxiter=STREAM_STEPS,
                               minibatch_size=MINIBATCH)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            rec.verify()
            check(model._index.train_size == STREAM_MEGA and model._index.test_size == 0,
                  "streaming: train split %d / test %d of a %d-row megabatch"
                  % (model._index.train_size, model._index.test_size, STREAM_MEGA))
            busy = busy_window(torch, hb, "streaming", opt, STREAM_CHUNK, run=lambda: (
                optimize_streaming(opt, rec, slices[:2], maxiter=STREAM_CHUNK,
                                   minibatch_size=MINIBATCH)))
    hist = np.concatenate(opt.history)[:STREAM_STEPS] / n
    first, last = check_rises(hist, "streaming", 50)
    megas = STREAM_STEPS // STREAM_CHUNK
    draws = megas * STREAM_MEGA
    distinct = np.unique(np.concatenate(rec.ids[:megas])).size / n
    expected = 1.0 - (1.0 - 1.0 / n) ** draws
    check(abs(distinct - expected) <= 0.01,
          "streaming: %.4f of the rows read, sampling with replacement expects %.4f"
          % (distinct, expected))
    rate = STREAM_STEPS / seconds
    print("streaming: n=%d rows (%.1f s to write) megabatch=%d minibatch=%d steps=%d "
          "megabatches=%d seconds=%.3f steps_per_s=%.1f (in-core phase 10: %.1f) "
          "elbo_per_point first50=%.4f last50=%.4f distinct rows read %.4f (expected %.4f); "
          "device copies checked %d; launches %s"
          % (n, write_s, STREAM_MEGA, MINIBATCH, STREAM_STEPS, megas, seconds, rate,
             in_core_rate, first, last, distinct, expected, rec.checked,
             " ".join("%s=%d" % kv for kv in sorted(launches.items()))))
    return {"steps_per_s": rate, "busy": busy, "in_core": in_core_rate}


SERVE_SIZES = (5, 64, 100, 200)  # 200 points: past K2's 128 columns
SERVE_TIMING_N = 64
SERVE_DRAWS = 32
SERVE_FIT_STEPS = 50
SHARD_FLEET_STEPS = 20
SHARD_RATE_STEPS = 100
SHARD_AMORT_STEPS = 200
SHARD_MB = 512
RANKS = 2
RANKS_STEPS = 10
RANKS_ROWS = 256                 # each rank's rows a step: 512 over the two
SHARD_EVIDENCE = ("log_marginal_laplace", "log_marginal_ep")
SHARD_EVIDENCE_STEPS = 10
SHARD_MC_STEPS = 5               # phase 17's multiclass, row-sharded
# the SVGP families of tests/test_parallel.py at its widths, over one NCCL
# rank: name -> (objective, rows, minibatch)
SHARD_FAMILIES = {"SVGPMulticlass": ("ELBO", 2048, 128),
                  "SVGPCount": ("ELBO_analytic", 2048, 128),
                  "HeteroSVGP": ("ELBO_analytic", 4096, 256),
                  "MultiOutputSVGP": ("ELBO_analytic", 4096, 256)}
SHARD_FAMILY_STEPS = 20

# phase 28: each example twin (henbun_tpu_torch/examples) at the JAX
# example's widths, only the step counts cut (the example's default in the
# comment), in the order the port took them up. Steps that an example fixes
# are not cut: gaussian_process's 800 natural-gradient and 600 Laplace
# steps (most of its time: a single model's Laplace steps run the generic
# Newton loop), bayes_hypers_sparse's 300 ML-II steps, the
# sparse Laplace fits' 60 in svgp_likelihoods, MultiOutputSVGP's 1,000 and
# amortized_svi's 500 warm-up steps
EXAMPLE_ARGV = (
    ("gaussian_process", ["--iters", "200"]),           # 20,000
    ("fleet", ["--iters", "100"]),                      # 4,000
    ("amortized_svi", ["--iters", "100"]),              # 5,000
    ("svgp_natgrad", ["--iters", "200"]),               # 2,000
    ("svgp_likelihoods", ["--iters", "50"]),            # 6,000
    ("linear_models", ["--map-iters", "300", "--vi-iters", "500"]),  # 3,000, 50,000
    ("gp_classification", ["--iters", "20"]),           # 500
    ("expert_gpr", ["--init-iters", "150", "--rounds", "1", "--iters", "100"]),  # 3,000; 10 x 1,000
    ("heteroscedastic", ["--iters", "50"]),             # 4,000
    ("multioutput", ["--iters", "50"]),                 # 20,000
    ("deep_gp", ["--iters", "50"]),                     # 6,000
    ("gplvm", ["--iters", "150"]),                      # 6,000
    ("hmc_bnn", ["--samples", "50", "--warmup", "50"]),  # 500 + 500
    ("smc_tomography", []),
    ("bayes_hypers_sparse", ["--samples", "20"]),       # 300 + 300
)
# twins whose path must launch these kernels
EXAMPLE_KERNELS = {"fleet": ("K1", "K2"), "svgp_natgrad": ("K1", "K2"),
                   "bayes_hypers_sparse": ("K1", "K2")}
# deterministic lines: the JAX example's reading on a CPU at the same argv
# (python examples/<name>.py <argv>, JAX_PLATFORMS=cpu), the first numbers
# after each label, held at EXAMPLE_RTOL. gaussian_process's three lines
# do not depend on --iters below 16,000 (800 natgrad and 600 Laplace steps)
EXAMPLE_READINGS = {
    "gaussian_process": {"robust ELBO (quadrature+natgrad):": (-47.85931396484375,),
                         "robust Laplace evidence:": (-47.97492218017578,),
                         "robust Laplace posterior-mean RMSE vs sin(x):": (0.10932200402021408,)},
    "linear_models": {"MAP:": (1.008, 1.951)},
    "gp_classification": {"Laplace evidence:": (-63.73707580566406,),
                          "EP evidence:": (-63.545,)},
}
EXAMPLE_RTOL = 1e-3
EXAMPLES_TIMEOUT = 300        # seconds phase 28's process may run past phase 27
# a printed number: signed decimal or exponent form, or nan / inf
EXAMPLE_NUMBER = r"[-+]?(?:(?<![A-Za-z])(?i:nan|inf)(?![A-Za-z])|(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)"

# the phase-26 child: a fresh process that imports torch and the serving
# module only, loads the saved artifact and serves each size on both
# programs, counting K1 and K2 launches per request
SERVE_CHILD = r"""
import json, sys
import numpy as np, torch
from henbun_tpu_torch import serving
art = serving.load(sys.argv[1])
chol = sys.modules["henbun_tpu_torch.ops.cuda_chol"].cholesky128_vbatched
solve = sys.modules["henbun_tpu_torch.ops.cuda_solve"].tri_solve128_vbatched
out, launches = {}, {}
for n in json.loads(sys.argv[2]):
    x = np.linspace(-0.5, 6.5, n, dtype=np.float32)[:, None]
    for dev in ("cuda", "cpu"):
        chol.launches = solve.launches = 0
        mean, var = art(torch.tensor(x, device=dev))
        torch.cuda.synchronize()
        launches["%s %d" % (dev, n)] = [chol.launches, solve.launches]
        out["%s_%d" % (dev, n)] = torch.cat([mean, var], 1).cpu().numpy()
mean, var = art(np.linspace(-0.5, 6.5, 16, dtype=np.float32)[:, None])
assert mean.device.type == "cuda", "a numpy request ran the %s program" % mean.device.type
assert "henbun_tpu_torch.models" not in sys.modules, "serving imported the models"
np.savez(sys.argv[3], **out)
print(json.dumps(launches))
"""


def serve_grid(n):
    return np.linspace(-0.5, 6.5, n, dtype=np.float32)[:, None]


def serving_phase(torch, hb):
    """26 · serving: MultiOutputGPR at families_bench.py's widths (n = 80,
    P = 3, Q = 2, per-latent kernels), fitted as phase 23 fits it; its
    predict_f exported batch-polymorphic for ("cpu", "cuda") and saved
    under chiprun_out/; loaded in a fresh python3 that imports torch and
    henbun_tpu_torch.serving only (it asserts that the models were never
    imported) and served at 5, 64, 100 and 200 points on both programs
    (and once from numpy, which must run the card's program).
    Each card answer equals the eager predict_f (rtol 1e-5, atol 1e-6),
    the CPU program's equals the card's (1e-4 of the output's scale); K1
    factors the latent grams once, in the first call's fold, and K2
    launches on the card for n* <= 128; the 200-point solve goes to
    torch.linalg (K2 0). Then the
    GPRMarginal predictor (torch.linalg by design) and a 32-draw sampler
    of GPR.predict_f with a fullrank q: the same seed gives bit-equal
    draws, another seed other draws. The artifact call's ms against the
    eager call's, from CUDA events."""
    from henbun_tpu_torch import serving

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    opt = mo_natgrad(hb, shared_kernel=False)
    opt.optimize(maxiter=SERVE_FIT_STEPS)
    model = opt.model
    t0 = time.perf_counter()
    art = serving.export_predictor(model, "predict_f", np.zeros((8, 1), np.float32),
                                   platforms=("cpu", "cuda"), batch_polymorphic=True)
    export_s = time.perf_counter() - t0
    path = os.path.join(out_dir, "serving_multioutput.pt2z")
    art.save(path)
    npz = os.path.join(out_dir, "serving_multioutput_served.npz")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SERVE_CHILD, path, json.dumps(SERVE_SIZES), npz],
                         env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
                         timeout=600)
    child_s = time.perf_counter() - t0
    check(res.returncode == 0, "serving child failed:\n%s\n%s" % (res.stdout[-3000:],
                                                                  res.stderr[-3000:]))
    launches = json.loads(res.stdout.strip().splitlines()[-1])
    served = np.load(npz)
    rows = []
    for n in SERVE_SIZES:
        x = serve_grid(n)
        mean, var = model.run(lambda mm: mm.predict_f(x))
        eager = torch.cat([mean, var], 1).cpu().numpy()
        card, cpu = served["cuda_%d" % n], served["cpu_%d" % n]
        check(card.shape == (n, 6) and np.isfinite(card).all() and np.isfinite(cpu).all(),
              "served n=%d: shape %r or not finite" % (n, card.shape))
        err = float(np.max(np.abs(card - eager) - 1e-5 * np.abs(eager)))
        check(err <= 1e-6, "served n=%d: card program vs eager predict_f beyond rtol 1e-5, "
              "atol 1e-6 by %g" % (n, err))
        rel = float(np.abs(cpu - card).max() / np.abs(card).max())
        check(rel <= 1e-4, "served n=%d: CPU program vs card program %g of the scale" % (n, rel))
        (k1, k2), (c1, c2) = launches["cuda %d" % n], launches["cpu %d" % n]
        check(c1 == 0 and c2 == 0, "served n=%d: the CPU program launched a kernel" % n)
        check((k1 > 0 if n == SERVE_SIZES[0] else k1 == 0) and (k2 > 0 if n <= 128 else k2 == 0),
              "served n=%d: K1=%d K2=%d launches on the card" % (n, k1, k2))
        rows.append((n, k1, k2, err, rel))
    xt = torch.tensor(serve_grid(SERVE_TIMING_N), device="cuda")
    art_ms = time_ms(torch, lambda: art(xt), iters=20, warmup=3)
    eager_ms = time_ms(torch, lambda: model.run(lambda mm: mm.predict_f(xt)), iters=20, warmup=3)
    print("serving: MultiOutputGPR n=%d P=3 Q=%d per-latent; export %.2f s (cpu + cuda), artifact "
          "%d bytes, fresh-process load and serve %.1f s; %s; at %d points artifact_ms=%.3f "
          "eager_ms=%.3f"
          % (MO_N, MO_Q, export_s, os.path.getsize(path), child_s,
             "; ".join("n=%d K1=%d K2=%d beyond-tol=%.2g cpu-vs-card=%.2g" % r for r in rows),
             SERVE_TIMING_N, art_ms, eager_ms))

    hb.set_seed(0)
    X, Y = hb.models.make_sine_dataset(n=N, seed=0)
    gm = hb.models.GPRMarginal(seed=0, X=X, Y=Y)
    gm.log_marginal().compile(hb.adam(0.05)).optimize(maxiter=SERVE_FIT_STEPS)
    gart = serving.export_predictor(gm, "predict_f", np.zeros((8, 1), np.float32),
                                    platforms=("cpu", "cuda"), batch_polymorphic=True)
    for n in (1, 64, 200):
        x = serve_grid(n)
        got = torch.cat(gart(torch.tensor(x, device="cuda")), 1).cpu().numpy()
        want = torch.cat(gm.run(lambda mm: mm.predict_f(x)), 1).cpu().numpy()
        check(np.all(np.abs(got - want) <= 1e-6 + 1e-5 * np.abs(want)),
              "GPRMarginal artifact n=%d vs eager" % n)
    g_art_ms = time_ms(torch, lambda: gart(xt), iters=20, warmup=3)
    g_eager_ms = time_ms(torch, lambda: gm.run(lambda mm: mm.predict_f(xt)), iters=20, warmup=3)

    q = hb.models.GPR(seed=0, X=X, Y=Y, q_shape="fullrank")
    q.ELBO_gaussian().compile(hb.adam(0.02)).optimize(maxiter=SERVE_FIT_STEPS)
    grid = np.linspace(0, 6, 50, dtype=np.float32)[:, None]
    t0 = time.perf_counter()
    sampler = serving.export_sampler(q, hb.models.GPR.predict_f, SERVE_DRAWS, grid,
                                     platforms=("cpu", "cuda"))
    sampler_s = time.perf_counter() - t0
    xg = torch.tensor(grid, device="cuda")
    s0, s1, s2 = sampler(7, xg), sampler(7, xg), sampler(8, xg)
    check(tuple(s0.shape) == (SERVE_DRAWS, 50, 1) and bool(torch.isfinite(s0).all()),
          "sampler artifact: shape %r or not finite" % (tuple(s0.shape),))
    check(bool(torch.equal(s0, s1)), "sampler artifact: the same seed gave other draws")
    check(float((s0 - s2).abs().max()) > 1e-6, "sampler artifact: another seed, the same draws")
    s_np = sampler(7, grid)
    check(s_np.device.type == "cuda" and bool(torch.equal(s_np, s0)),
          "sampler artifact: a numpy request did not run the card's program")
    s_ms = time_ms(torch, lambda: sampler(7, xg), iters=20, warmup=3)
    print("serving: GPRMarginal n=%d artifact_ms=%.3f eager_ms=%.3f at %d points; GPR fullrank "
          "sampler %d draws x 50 points: export %.2f s, call_ms=%.3f, band %.3f"
          % (N, g_art_ms, g_eager_ms, SERVE_TIMING_N, SERVE_DRAWS, sampler_s, s_ms,
             float(2 * s0[:, :, 0].std(0).mean())))
    return {"launches": {n: (k1, k2) for n, k1, k2, _, _ in rows}, "artifact_ms": art_ms,
            "eager_ms": eager_ms}


def evidence_step(torch, opt):
    """One zero-learning-rate step of an evidence Optimizer (a
    ShardedOptimizer reduces the gradient over its ranks in it): the
    objective, its gradient ({leaf: numpy}), the row sums' all-reduces
    (calls, bytes) of the step and the rows this rank held."""
    from henbun_tpu_torch.parallel import rows

    opt.compile(optimizer=lambda params: torch.optim.SGD(params, lr=0.0))
    rows.reset_stats()
    opt.optimize(maxiter=1)
    grads = {k: -t.grad.detach().cpu().numpy() for k, t in opt._trainable.items()}
    return {"value": float(opt.history[-1][0]), "grads": grads, "stats": dict(rows.stats),
            "block": getattr(opt, "_row_block", None)}


def sharded_evidence_runs(torch, hb, make_opt):
    """Phase 27's full-width evidence (phase 14's SparseGPC at n = 1e5,
    m = 128) with make_opt(model, method) as the optimizer, for each of
    SHARD_EVIDENCE: the zero step at the initial weights, then
    SHARD_EVIDENCE_STEPS Adam(0.05) steps from them (history, seconds,
    the last ep_delta)."""
    data = sparse_data(SPARSE_N)
    out = {}
    for method in SHARD_EVIDENCE:
        got = evidence_step(torch, make_opt(sparse_model(hb, data, "gpc"), method))
        opt = make_opt(sparse_model(hb, data, "gpc"), method).compile(hb.adam(0.05))
        got["hist"], got["seconds"], _ = run_path(torch, hb, opt, SHARD_EVIDENCE_STEPS)
        got["ep_delta"] = opt.metrics.rows[-1].get("ep_delta")
        out[method] = got
    return out


def evidence_float64(torch, hb, method):
    """The one-process gradient of `method` on the card in float64 at the
    initial weights (held()'s arbiter)."""
    data = sparse_data(SPARSE_N)
    m = sparse_model(hb, data, "gpc")
    m.initialize()  # the staged initial values
    params = {k: v.detach().cpu() for k, v in m.param_dict().items()}
    cfg = hb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with hb.settings.temp_settings(cfg):
        m = sparse_model(hb, data, "gpc")
        m.set_param_dict({k: v.double() for k, v in params.items()})
        return value_and_grad(getattr(m, method)().compile(learning_rate=0.05))[1]


def sharded_multiclass_run(torch, hb, X, y, make_opt):
    """Phase 27's row-sharded multiclass (phase 17's SparseGPMulticlass at
    n = 1e5, m = 128, K = 3) with make_opt(model) as the optimizer of its
    log_marginal_laplace: the zero step at the initial weights, then
    SHARD_MC_STEPS Adam(0.05) steps from them (history, seconds, the
    trained weights)."""
    got = evidence_step(torch, make_opt(multiclass_model(hb, X, y, "cuda")))
    m = multiclass_model(hb, X, y, "cuda")
    opt = make_opt(m).compile(hb.adam(0.05))
    got["hist"], got["seconds"], _ = run_path(torch, hb, opt, SHARD_MC_STEPS)
    got["params"] = {k: v.detach().cpu().numpy() for k, v in m.param_dict().items()}
    return got


def multiclass_float64(torch, hb, X, y):
    """The one-process multiclass gradient on the card in float64 at the
    initial weights (held()'s arbiter at MC_F64_LIMITS)."""
    m = multiclass_model(hb, X, y, "cuda")
    m.initialize()  # the staged initial values
    params = {k: v.detach().cpu() for k, v in m.param_dict().items()}
    cfg = hb.settings.get_settings()
    cfg.dtypes.float_type = torch.float64
    with hb.settings.temp_settings(cfg):
        m = multiclass_model(hb, X, y, "cuda")
        m.set_param_dict({k: v.double() for k, v in params.items()})
        return value_and_grad(m.log_marginal_laplace().compile(learning_rate=0.05))[1]


def sharded_multiclass_check(torch, label, got, one, g64, exact):
    """A row-sharded multiclass run against the one-process card run: bit
    for bit where `exact` (one rank), else the objective at rtol 1e-5;
    every gradient leaf held to the card's float64 at MC_F64_LIMITS; the
    Adam steps finite and rising. Returns the text to print."""
    rel = abs(got["value"] - one["value"]) / abs(one["value"])
    if exact:
        same = (got["value"] == one["value"] and np.array_equal(got["hist"], one["hist"])
                and all(np.array_equal(got["grads"][k], v) for k, v in one["grads"].items())
                and all(np.array_equal(got["params"][k], v) for k, v in one["params"].items()))
        check(same, "%s: not bit for bit the one-process run (objective rel %g)" % (label, rel))
    check(rel <= 1e-5, "%s: objective %r against one process %r (rel %g)"
          % (label, got["value"], one["value"], rel))
    text = held(torch, label, (got["value"], got["grads"]), (one["value"], one["grads"]),
                lambda: g64, f64_limits=MC_F64_LIMITS)
    first, last = check_rises(got["hist"] / MC_N, label, 2)
    return ("%s;%s rows %s; %d Adam steps per point %.5f -> %.5f; row all-reduces a step %d "
            "(%d bytes); steps_per_s %.2f (one process %.2f)"
            % (text, " bit for bit;" if exact else "", got["block"], SHARD_MC_STEPS, first, last,
               got["stats"]["calls"], got["stats"]["bytes"], SHARD_MC_STEPS / got["seconds"],
               SHARD_MC_STEPS / one["seconds"]))


def family_model(hb, name):
    """tests/test_parallel.py's SVGP family `name` at its widths (m = 16)
    on the card."""
    rng = np.random.default_rng(1)
    X = np.sort(rng.uniform(0, 6, size=(2048, 1)).astype(np.float32), axis=0)
    hb.set_seed(0)
    if name == "SVGPMulticlass":
        labels = (np.floor(X[:, 0]) % 3).astype(np.int32)[:, None]
        return hb.models.SVGPMulticlass(seed=1, X=X, Y=labels, num_classes=3, num_inducing=16)
    if name == "SVGPCount":
        Yp = rng.poisson(np.exp(np.sin(X) + 1.0)).astype(np.float32)
        return hb.models.SVGPCount(seed=1, X=X, Y=Yp, num_inducing=16)
    if name == "HeteroSVGP":
        Xh, Yh, _ = hb.models.make_hetero_dataset(n=4096, seed=0)
        return hb.models.HeteroSVGP(seed=0, X=Xh, Y=Yh, num_inducing=16)
    Xm, Ym, _ = hb.models.make_multioutput_dataset(n=4096, seed=0)
    return hb.models.MultiOutputSVGP(seed=0, X=Xm, Y=Ym, Q=2, num_inducing=16)


def sharded_families(torch, hb, mesh):
    """The SVGP families of tests/test_parallel.py over a one-rank NCCL
    mesh, SHARD_FAMILY_STEPS Adam(0.02) steps each on the same injected
    rows against the unsharded Optimizer drawing the same noise from the
    same seed (1e-6 relative, objectives and weights), and the steps'
    collectives a step (the gradient and objective all-reduce; no row sum,
    no chain collective). Returns the texts to print."""
    from henbun_tpu_torch.parallel import ShardedOptimizer, chains, rows, sharding

    texts = []
    for name, (method, n, mb) in SHARD_FAMILIES.items():
        runs = {}
        for sharded in (False, True):
            m = family_model(hb, name)
            opt = ShardedOptimizer(m, method, mesh=mesh) if sharded else getattr(m, method)()
            opt.compile(hb.adam(0.02))
            train = np.asarray(m._index._train_index)
            pos = np.random.default_rng(2727).integers(0, len(train), (SHARD_FAMILY_STEPS, mb))
            # the shard of one rank is the whole permuted train split
            opt.row_source = (lambda s: pos[s]) if sharded else (lambda s: train[pos[s]])
            for mod in (sharding, rows, chains):
                mod.reset_stats()
            hist, seconds, _ = run_path(torch, hb, opt, SHARD_FAMILY_STEPS, minibatch_size=mb)
            runs[sharded] = (hist, {k: v.detach().cpu().numpy() for k, v in m.param_dict().items()},
                             dict(sharding.stats), rows.stats["calls"] + chains.stats["calls"],
                             SHARD_FAMILY_STEPS / seconds,
                             sum(t.numel() for t in opt._trainable.values()))
        (h0, p0, _, _, rate0, _), (h1, p1, st, other, rate1, floats) = runs[False], runs[True]
        check(np.isfinite(h1).all(), "sharded %s: objective not finite" % name)
        rel = float(np.max(np.abs(h1 - h0) / np.abs(h0)))
        prel = max(float(np.abs(p1[k] - v).max() / max(np.abs(v).max(), 1e-6))
                   for k, v in p0.items())
        check(rel <= 1e-6 and prel <= 1e-6, "sharded %s vs Optimizer: objective %g, weights %g "
              "relative" % (name, rel, prel))
        check(st == {"calls": SHARD_FAMILY_STEPS,
                     "bytes": SHARD_FAMILY_STEPS * 4 * (floats + 1)} and other == 0,
              "sharded %s: collectives %r (row or chain %d), want one all-reduce of %d floats a "
              "step" % (name, st, other, floats + 1))
        texts.append("%s.%s n=%d minibatch %d, %d steps: max rel vs Optimizer %.3g (weights %.3g); "
                     "all-reduces a step %d (%d bytes, %d parameters + 1); steps_per_s sharded=%.1f "
                     "unsharded=%.1f"
                     % (name, method, n, mb, SHARD_FAMILY_STEPS, rel, prel,
                        st["calls"] // SHARD_FAMILY_STEPS, st["bytes"] // SHARD_FAMILY_STEPS,
                        floats, rate1, rate0))
    return texts


def sharded_evidence_checks(torch, hb, label, runs, one):
    """Each run of `runs` (sharded_evidence_runs' results on an optimizer)
    against the one-process card run `one`: the objective at rtol 1e-5,
    each gradient leaf within 1e-4 of its largest entry or arbitrated by
    the card's float64 (held(), phase 14's float32 tolerances), the
    Adam steps finite and rising, the EP's ep_delta under its guard.
    Returns the text to print."""
    texts = []
    for method, got in runs.items():
        want = one[method]
        rel = abs(got["value"] - want["value"]) / abs(want["value"])
        check(rel <= 1e-5, "%s %s: objective %r against one process %r (rel %g)"
              % (label, method, got["value"], want["value"], rel))
        tol = SPARSE_EP_F32_TOL if method == "log_marginal_ep" else SPARSE_LAPLACE_F32_TOL
        text = held(torch, "%s %s" % (label, method), (got["value"], got["grads"]),
                    (want["value"], want["grads"]), lambda: evidence_float64(torch, hb, method),
                    tol)
        first, last = check_rises(got["hist"] / SPARSE_N, "%s %s" % (label, method), 5)
        if method == "log_marginal_ep":
            check(got["ep_delta"] < 1e-2, "%s %s: ep_delta %g" % (label, method, got["ep_delta"]))
        hist_rel = float(np.max(np.abs(got["hist"] - want["hist"]) / np.abs(want["hist"])))
        texts.append("%s; rows %s; %d Adam steps per point %.5f -> %.5f, max rel vs one process "
                     "%.3g%s; row all-reduces a step %d (%d bytes); steps_per_s %.2f "
                     "(one process %.2f)"
                     % (text, got["block"], SHARD_EVIDENCE_STEPS, first, last, hist_rel,
                        "" if got["ep_delta"] is None else ", ep_delta %.3g (one process %.3g)"
                        % (got["ep_delta"], want["ep_delta"]),
                        got["stats"]["calls"], got["stats"]["bytes"],
                        SHARD_EVIDENCE_STEPS / got["seconds"],
                        SHARD_EVIDENCE_STEPS / want["seconds"]))
    return texts


def parallel_phase(torch, hb):
    """27 · parallel on the card. World size 1 over NCCL (the one-rank
    group make_mesh starts): ShardedBatchedOptimizer on phase 4's 16-model
    fleet for 20 steps under injected noise against BatchedOptimizer
    (within 1e-6 relative, the same K1 and K2 launches a step), and
    ShardedOptimizer on the amortized path (phase 10's model, minibatch
    512) against the plain driver, steps/s each (the fleet's from 100
    more steps, after NCCL's lazy set-up). Then two ranks on the one
    card over gloo with CUDA tensors (NCCL refuses two ranks on one
    device), spawned from the phase: the same minibatch amortized fit with
    each rank's rows and noise injected, 10 steps, against the
    one-process run on the union of the rows (rtol 1e-5); then the same
    with the noise drawn, against the one-process run drawing its own.
    Then the row-sharded full-batch evidence at phase 14's width over
    one process, one NCCL rank and the two gloo ranks
    (sharded_evidence_checks), and phase 17's SparseGPMulticlass evidence
    the same three ways (sharded_multiclass_check: one NCCL rank bit for
    bit, the gloo ranks within 1e-5, every leaf held to the card's
    float64); over the NCCL rank the SVGP families of
    tests/test_parallel.py against the unsharded Optimizer
    (sharded_families); and entry.dryrun_multichip(1) and (2). The two
    ranks and the dry runs (in a thread) start with the phase and run
    beside its in-process parts."""
    import atexit
    import tempfile
    import threading

    import torch.distributed as dist
    from henbun_tpu_torch import entry, parallel

    # the spawned processes (the two gloo ranks, then the dry runs) run
    # while this process runs its own parts
    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(27)
    local_n = (AMORT_N - AMORT_N // 10) // RANKS
    pos = rng.integers(0, local_n, (RANKS, RANKS_STEPS, RANKS_ROWS))
    u = rng.standard_normal((RANKS_STEPS, RANKS * RANKS_ROWS, 4)).astype(np.float32)
    X_mc, y_mc = multiclass_data(MC_N)
    d = tempfile.TemporaryDirectory()
    np.savez(os.path.join(d.name, "inputs.npz"), pos=pos, noise=u, mc_X=X_mc, mc_y=y_mc)
    t_spawn = time.perf_counter()
    procs = []
    for r in range(RANKS):
        with open(os.path.join(d.name, "rank%d.log" % r), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), str(RANKS), d.name],
                env=dict(os.environ, PYTHONPATH=here), stdout=log, stderr=subprocess.STDOUT))

    def stop_ranks():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop_ranks)
    # the port's twin of __graft_entry__.dryrun_multichip: one NCCL rank,
    # then two gloo ranks sharing the card
    dry = {}

    def dry_runs():
        for n in (1, 2):
            t1 = time.perf_counter()
            try:
                dry[n] = (entry.dryrun_multichip(n), time.perf_counter() - t1)
            except Exception as e:  # reported after the join
                dry[n] = e
                return

    dry_thread = threading.Thread(target=dry_runs, daemon=True)
    dry_thread.start()

    mesh = parallel.make_mesh(device_type="cuda")
    check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
          "world-1 mesh: backend %s shape %r" % (dist.get_backend(), tuple(mesh.shape)))
    g = torch.Generator(device="cuda")
    g.manual_seed(2727)
    noise_of = [{"q": torch.randn(FLEET, N, generator=g, device="cuda")}
                for _ in range(SHARD_FLEET_STEPS)]
    method, lr = FLEETS["gpr"]
    fleets = {}
    for sharded in (False, True):
        models = make_models(hb, "cuda", "gpr")
        bo = (parallel.ShardedBatchedOptimizer(models, method, mesh=mesh) if sharded
              else hb.BatchedOptimizer(models, method))
        bo.compile(learning_rate=lr)
        bo.noise_source = lambda step: noise_of[step]
        hist, _, launches = run_path(torch, hb, bo, SHARD_FLEET_STEPS)
        # steps/s from a second run: the first holds NCCL's lazy set-up
        bo.noise_source = None
        _, seconds, _ = run_path(torch, hb, bo, SHARD_RATE_STEPS)
        fleets[sharded] = (hist, SHARD_RATE_STEPS / seconds, launches)
    rel = float(np.max(np.abs(fleets[True][0] - fleets[False][0]) / np.abs(fleets[False][0])))
    check(rel <= 1e-6, "sharded fleet vs BatchedOptimizer: %g relative" % rel)
    for k in ("K1", "K2"):
        check(fleets[True][2][k] == fleets[False][2][k] > 0,
              "sharded fleet %s launches %d vs %d" % (k, fleets[True][2][k], fleets[False][2][k]))
    print("parallel: world 1 nccl; fleet %dx%d %d steps sharded vs BatchedOptimizer max rel %.3g, "
          "K1/K2 a step %.2f/%.2f (both), steps_per_s over %d more steps sharded=%.1f "
          "unsharded=%.1f"
          % (FLEET, N, SHARD_FLEET_STEPS, rel, fleets[True][2]["K1"] / SHARD_FLEET_STEPS,
             fleets[True][2]["K2"] / SHARD_FLEET_STEPS, SHARD_RATE_STEPS, fleets[True][1],
             fleets[False][1]))

    X, Y = hb.models.make_synthetic_regression(n=AMORT_N, d_x=8, seed=0)
    amort = {}
    for sharded in (False, True):
        hb.set_seed(0)
        m = hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=4, hidden=64)
        opt = parallel.ShardedOptimizer(m, "ELBO", mesh=mesh) if sharded else m.ELBO()
        opt.compile(hb.adam(0.003))
        hist, seconds, _ = run_path(torch, hb, opt, SHARD_AMORT_STEPS, minibatch_size=SHARD_MB)
        check_rises(hist / AMORT_N, "sharded amortized" if sharded else "amortized", 50)
        amort[sharded] = SHARD_AMORT_STEPS / seconds
    dist.destroy_process_group()
    print("parallel: world 1 nccl; amortized n=%d minibatch %d, %d steps: steps_per_s "
          "ShardedOptimizer=%.1f Optimizer=%.1f"
          % (AMORT_N, SHARD_MB, SHARD_AMORT_STEPS, amort[True], amort[False]))

    # the row-sharded full-batch evidence at phase 14's width: one process,
    # then one NCCL rank (a one-rank data axis takes every row)
    t_added = time.perf_counter()
    one = sharded_evidence_runs(torch, hb, lambda m, method: getattr(m, method)())
    one_mc = sharded_multiclass_run(torch, hb, X_mc, y_mc, lambda m: m.log_marginal_laplace())
    mesh = parallel.make_mesh(device_type="cuda")
    nccl1 = sharded_evidence_runs(torch, hb, lambda m, method: parallel.ShardedOptimizer(
        m, method, mesh=mesh))
    nccl1_mc = sharded_multiclass_run(torch, hb, X_mc, y_mc, lambda m: parallel.ShardedOptimizer(
        m, "log_marginal_laplace", mesh=mesh))
    t0 = time.perf_counter()
    family_texts = sharded_families(torch, hb, mesh)
    families_s = time.perf_counter() - t0
    dist.destroy_process_group()
    for text in sharded_evidence_checks(torch, hb, "sharded evidence world 1 nccl", nccl1, one):
        print("parallel: " + text)
    g64_mc = multiclass_float64(torch, hb, X_mc, y_mc)
    print("parallel: " + sharded_multiclass_check(
        torch, "sharded multiclass world 1 nccl", nccl1_mc, one_mc, g64_mc, exact=True))
    for text in family_texts:
        print("parallel: world 1 nccl; " + text)
    print("parallel: the SVGP families took %.1f s" % families_s)
    added = time.perf_counter() - t_added - families_s

    try:
        for p in procs:
            p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_ranks()
    spawn_s = time.perf_counter() - t_spawn
    for r, p in enumerate(procs):
        with open(os.path.join(d.name, "rank%d.log" % r)) as f:
            check(p.returncode == 0, "rank %d failed:\n%s" % (r, f.read()[-4000:]))
    out = [torch.load(os.path.join(d.name, "rank%d.pt" % r), weights_only=False)
           for r in range(RANKS)]
    d.cleanup()
    union = np.concatenate([o["rows"] for o in out], axis=1)
    noise_card = torch.tensor(u, device="cuda")
    worst, one_s = {}, None
    for case in ("injected", "drawn"):
        hb.set_seed(0)
        m = hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=4, hidden=64)
        opt = m.ELBO().compile(hb.adam(0.003))
        opt.row_source = lambda s: union[s]
        if case == "injected":
            opt.noise_source = lambda s: {"z": noise_card[s]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize(maxiter=RANKS_STEPS, minibatch_size=RANKS * RANKS_ROWS)
        torch.cuda.synchronize()
        one_s = one_s or time.perf_counter() - t0
        want = opt.history[-1]
        worst[case] = 0.0
        for o in out:
            check(o["backend"] == "gloo" and o["device"].startswith("cuda"),
                  "rank ran on %s over %s" % (o["device"], o["backend"]))
            got = o[case]
            worst[case] = max(worst[case], float(np.max(np.abs(got["hist"] - want)
                                                        / np.abs(want))))
            for k, v in m.param_dict().items():
                ref = v.detach().cpu().numpy()
                worst_p = float(np.max(np.abs(got["params"][k] - ref))
                                / max(np.abs(ref).max(), 1e-6))
                check(worst_p <= 1e-5, "2-rank %s (noise %s) vs one process: %g of the scale"
                      % (k, case, worst_p))
        check(worst[case] <= 1e-5, "2-rank objectives (noise %s) vs one process on the union: "
              "%g relative" % (case, worst[case]))
    print("parallel: 2 ranks gloo on one card, amortized n=%d, %d rows a rank, %d steps: "
          "objective max rel vs one process %.3g (noise injected), %.3g (noise drawn); spawn to "
          "results %.1f s; steps_per_s ranks=%s one_process=%.1f"
          % (AMORT_N, RANKS_ROWS, RANKS_STEPS, worst["injected"], worst["drawn"], spawn_s,
             "/".join("%.1f" % (RANKS_STEPS / o["injected"]["seconds"]) for o in out),
             RANKS_STEPS / one_s))
    t0 = time.perf_counter()
    blocks = {method: [o["evidence"][method]["block"] for o in out] for method in SHARD_EVIDENCE}
    for method, b in blocks.items():
        check(b == [(0, SPARSE_N // 2), (SPARSE_N // 2, SPARSE_N)],
              "2-rank %s: row blocks %r" % (method, b))
    b = [o["multiclass"]["block"] for o in out]
    check(b == [(0, MC_N // 2), (MC_N // 2, MC_N)], "2-rank multiclass: row blocks %r" % (b,))
    for r, o in enumerate(out):
        for text in sharded_evidence_checks(torch, hb, "sharded evidence 2 ranks gloo, rank %d"
                                            % r, o["evidence"], one):
            print("parallel: " + text)
        print("parallel: " + sharded_multiclass_check(
            torch, "sharded multiclass 2 ranks gloo, rank %d" % r, o["multiclass"], one_mc,
            g64_mc, exact=False))
    added += time.perf_counter() - t0 + max(o["evidence_s"] for o in out)

    dry_thread.join()
    for n, backend in ((1, "nccl"), (2, "gloo")):
        if isinstance(dry.get(n), Exception):
            fail("dryrun_multichip(%d): %s" % (n, dry[n]))
        check(n in dry, "dryrun_multichip(%d) did not run" % n)
        res, seconds = dry[n]
        for o in res:
            check(o["backend"] == backend and o["device"].startswith("cuda"),
                  "dryrun_multichip(%d): rank ran on %s over %s" % (n, o["device"], o["backend"]))
        print("parallel: dryrun_multichip(%d) over %s on the card in %.1f s (beside the phase's "
              "other work): %s"
              % (n, backend, seconds, json.dumps({k: v for k, v in res[0].items()
                                                  if k not in ("backend", "device")})))
    print("parallel: the row-sharded evidence checks took %.1f s of this phase, the dry runs "
          "%.1f s beside it" % (added, sum(v[1] for v in dry.values())))
    return {"fleet": fleets, "amortized": amort, "evidence": one,
            "dryrun_s": {n: v[1] for n, v in dry.items()}}


def example_numbers(line):
    return [float(x) for x in re.findall(EXAMPLE_NUMBER, line)]


def examples_phase(torch, hb):
    """Phase 28: each example twin's main() on the card at EXAMPLE_ARGV,
    its stdout captured; its seconds, its K1-K3 launches and its printed
    lines. Every printed number finite; the twins of EXAMPLE_KERNELS launch
    their kernels; each deterministic line within EXAMPLE_RTOL of the JAX
    example's CPU reading; the SMC twin's final beta and posterior mean
    within phase 20's limits."""
    import contextlib
    import importlib
    import io

    counters = kernel_counters()
    out = {}
    for name, argv in EXAMPLE_ARGV:
        mod = importlib.import_module("henbun_tpu_torch.examples." + name)
        buf = io.StringIO()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        print("examples: %s %s seconds=%.3f launches %s"
              % (name, " ".join(argv) or "(defaults)", seconds,
                 " ".join("%s=%d" % kv for kv in sorted(launches.items()))))
        for ln in lines:
            print("  | " + ln)
        for ln in lines:
            check(all(np.isfinite(example_numbers(ln))), "examples: %s printed %r" % (name, ln))
        for k in EXAMPLE_KERNELS.get(name, ()):
            check(launches[k] > 0, "examples: %s launched no %s" % (name, k))
        for label, want in EXAMPLE_READINGS.get(name, {}).items():
            found = [example_numbers(ln[len(label):])[:len(want)] for ln in lines
                     if ln.startswith(label)]
            check(len(found) == 1, "examples: %s printed %d lines %r" % (name, len(found), label))
            rel = max(abs(g - w) / abs(w) for g, w in zip(found[0], want))
            check(rel <= EXAMPLE_RTOL, "examples: %s %r %s, the JAX example's CPU reading %s "
                  "(rel %.3g, rtol %g)" % (name, label, found[0], want, rel, EXAMPLE_RTOL))
            print("  %s %s vs the JAX example's CPU reading %s: rel %.3g"
                  % (label, " ".join("%.9g" % g for g in found[0]),
                     " ".join("%.9g" % w for w in want), rel))
        if name == "smc_tomography":
            text = "\n".join(lines)
            beta = float(re.search(r"final beta: (\S+)", text).group(1))
            err = float(re.search(r"posterior-mean error vs analytic: (\S+)", text).group(1))
            check(beta > 1.0 - 1e-5, "examples: smc final beta %g" % beta)
            check(err < SMC_MEAN_GATE, "examples: smc posterior mean abs err %g, gate %g"
                  % (err, SMC_MEAN_GATE))
        out[name] = {"seconds": seconds, "launches": launches}
    print("examples: %d twins in %.1f s; K1/K2/K3 launches %s"
          % (len(out), sum(v["seconds"] for v in out.values()),
             ", ".join("%s=%d/%d/%d" % (k, v["launches"]["K1"], v["launches"]["K2"],
                                         v["launches"]["K3"]) for k, v in out.items())))
    return out


def start_examples():
    """Start phase 28 in a process of its own, `chip_smoke.py --examples
    <dir>`, its output to <dir>/log and its result to <dir>/examples.json:
    it runs beside phases 21-27, whose host rates it shares the cores
    with. It is killed if this process exits first."""
    import atexit
    import tempfile

    d = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(d.name, "log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--examples", d.name],
                                env=dict(os.environ, PYTHONPATH=here), stdout=log,
                                stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, d, stop


def join_examples(proc, d, stop):
    """Wait for phase 28's process (EXAMPLES_TIMEOUT), print its output,
    fail if it failed; returns its result."""
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=EXAMPLES_TIMEOUT)
    except subprocess.TimeoutExpired:
        stop()
    waited = time.perf_counter() - t0
    with open(os.path.join(d.name, "log")) as f:
        text = f.read()
    sys.stdout.write(text)
    check(proc.returncode == 0, "examples process failed (exit %s):\n%s"
          % (proc.returncode, text[-3000:]))
    with open(os.path.join(d.name, "examples.json")) as f:
        out = json.load(f)
    d.cleanup()
    print("examples: its process ended %.1f s after phase 27" % waited)
    return out


def examples_main(directory):
    """Phase 28 alone, in the process start_examples starts."""
    import torch

    check(torch.cuda.is_available(), "examples: torch finds no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import henbun_tpu_torch as hb
    from henbun_tpu_torch.ops import _build

    _build.build_all()
    t0 = time.perf_counter()
    out = examples_phase(torch, hb)
    print("examples phase: %.1f s in its own process" % (time.perf_counter() - t0))
    with open(os.path.join(directory, "examples.json"), "w") as f:
        json.dump(out, f)


def rank_main(rank, world, directory):
    """One rank of phase 27's two-rank run: gloo over a FileStore in
    `directory`, CUDA tensors, this rank's rows injected, its noise
    injected and then drawn; then the row-sharded evidence runs and the
    row-sharded multiclass."""
    import torch
    import torch.distributed as dist

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import henbun_tpu_torch as hb
    from henbun_tpu_torch import parallel

    parallel.initialize_distributed("file://" + os.path.join(directory, "store"), world, rank,
                                    backend="gloo")
    mesh = parallel.make_mesh(device_type="cuda")
    inp = np.load(os.path.join(directory, "inputs.npz"))
    pos = inp["pos"][rank]
    k = pos.shape[1]
    noise = torch.tensor(inp["noise"][:, rank * k:(rank + 1) * k], device="cuda")
    X, Y = hb.models.make_synthetic_regression(n=AMORT_N, d_x=8, seed=0)
    out = {}
    for drawn in (False, True):  # the noise injected, then drawn
        hb.set_seed(0)
        m = hb.models.AmortizedRegression(seed=0, X=X, Y=Y, d_z=4, hidden=64)
        opt = parallel.ShardedOptimizer(m, "ELBO", mesh=mesh).compile(hb.adam(0.003))
        opt.row_source = lambda s: pos[s]
        if not drawn:
            opt.noise_source = lambda s: {"z": noise[s]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize(maxiter=RANKS_STEPS, minibatch_size=world * k)
        torch.cuda.synchronize()
        out["drawn" if drawn else "injected"] = {
            "hist": opt.history[-1], "seconds": time.perf_counter() - t0,
            "params": {p: v.detach().cpu().numpy() for p, v in m.param_dict().items()}}
    local_n = len(m._index._train_index) // world
    out.update(backend=dist.get_backend(), device=str(noise.device),
               rows=m._index._train_index[rank * local_n + pos[:RANKS_STEPS]])
    t0 = time.perf_counter()
    out["evidence"] = sharded_evidence_runs(
        torch, hb, lambda model, method: parallel.ShardedOptimizer(model, method, mesh=mesh))
    out["multiclass"] = sharded_multiclass_run(
        torch, hb, inp["mc_X"], inp["mc_y"],
        lambda model: parallel.ShardedOptimizer(model, "log_marginal_laplace", mesh=mesh))
    out["evidence_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(directory, "rank%d.pt" % rank))
    dist.destroy_process_group()


def all_counters():
    from henbun_tpu_torch.ops import cuda_chol, cuda_wide

    out = kernel_counters()
    out.update(K4=cuda_chol.cholesky128, K5=cuda_chol.cholesky128_batched,
               K6l=cuda_wide.wide_lsolve128, K6u=cuda_wide.wide_usolve128)
    return out


def main():
    t_start = time.perf_counter()
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
            if "registers" in line or "smem" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, hb, *args)
        print("%s phase: %.1f s" % (name, time.perf_counter() - t0), flush=True)
        return out

    errs, times = timed("kernel", kernel_phase)
    # K4-K6 have no production caller: these are the kernel phase's own calls
    check_calls = {k: c.launches for k, c in all_counters().items() if k[:2] in ("K4", "K5", "K6")}
    print("kernel phase launches (checks and timing) %s"
          % " ".join("%s=%d" % kv for kv in sorted(check_calls.items())))
    gpr_launches, steps_per_s = timed("path", path_phase)
    timed("agreement", agreement_phase)
    laplace = timed("laplace", laplace_phase)
    timed("laplace agreement", laplace_agreement_phase)
    timed("profile", profile_phase)
    timed("laplace profile", profile_phase, "laplace", LAPLACE_PROFILE_STEPS)
    timed("single", single_phase)
    amortized = timed("amortized", amortized_phase)
    svgp = timed("svgp", svgp_phase)
    ng_fleet = timed("natgrad fleet", natgrad_fleet_phase)
    blocked = timed("blocked", blocked_phase)
    marginal = timed("exact-gram", marginal_phase)
    ep_fleets = timed("ep fleet", ep_fleet_phase)
    sparse = timed("sparse evidence", sparse_phase)
    sparse_fleet = timed("sparse fleet", sparse_fleet_phase)
    timed("resume", resume_phase, sparse["SparseGPC laplace"]["resume"])
    later = {name: timed(name, phase) for name, phase in (
        ("multiclass", multiclass_phase), ("samplers", sampler_phase),
        ("bayes", bayes_phase), ("smc", smc_phase))}
    # phase 28 runs in a process of its own beside phases 21-27
    examples = start_examples()
    families = {name: timed(name, phase, *args) for name, phase, args in (
        ("expert", expert_phase, ()), ("hetero", hetero_phase, ()),
        ("multioutput", multioutput_phase, ()), ("deep", deep_phase, ()),
        ("streaming", streaming_phase, (amortized["diagonal"]["steps_per_s"],)),
        ("serving", serving_phase, ()), ("parallel", parallel_phase, ()))}
    families["examples"] = join_examples(*examples)
    print("chip_smoke: phases 1-28 in %.1f s" % (time.perf_counter() - t_start), flush=True)

    # launches: the Laplace fleet's path run for K1-K3 (every one of them
    # runs on it; the GPR path's K1 and K2 counts are on its own line
    # above); K4-K6 have no production caller, so no path launches them:
    # their count is the exact-gram path's (0 on every path)
    launches = dict(laplace["laplace"][0])
    ml = marginal["launches"]
    launches.update(K4=ml["K4"], K5=ml["K5"], K6=ml["K6l"] + ml["K6u"])
    kernels = []
    for name, src, replaces, key, row, cost in (
        ("cholesky128_vbatched", "chol128.cu", "pallas_chol.py:140", "K1",
         times[("K1", FLEET, N)], chol_cost(FLEET, N)),
        ("tri_solve128_vbatched", "trisolve128.cu", "pallas_solve.py:140", "K2",
         times[("K2", FLEET, N, N, True)], solve_cost(FLEET, N, N)),
        ("newton_mode_vbatched", "newton128.cu", "pallas_newton.py:276", "K3",
         times[("K3", "student_t", FLEET, N, N)], newton_cost(FLEET, N, N, 15)),
        ("cholesky128", "chol128.cu", "pallas_chol.py:73", "K4",
         times[("K4", 128)], chol_cost(1, 128)),
        ("cholesky128_batched", "chol128.cu", "pallas_chol.py:175", "K5",
         times[("K5", 256, 128)], chol_cost(256, 128)),
        ("wide_lsolve128/wide_usolve128", "widesolve128.cu", "pallas_wide.py:122", "K6",
         times[("K6", False, 3968)], wide_cost(3968)),
    ):
        bound_ms, bound_by = bound(*cost)
        kernels.append(dict(
            name=name, route="cuda", source="henbun_tpu_torch/csrc/" + src,
            replaces="henbun_tpu/ops/" + replaces, launches=launches[key],
            max_abs_err=errs[key], ms=row["ms"], device_ms=row["device_ms"],
            plain_ms=row["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=row["library_ms"], library_device_ms=row["library_device_ms"],
        ))
    print("timed at the paths' shapes: K1 B=%d n=%d; K2 B=%d n=m=%d transpose=True; K3 "
          "student_t B=%d n=m=%d; launches from the Laplace fleet's %d steps (GPR path: "
          "K1=%d K2=%d); GPR fleet steps_per_s=%.1f, Laplace fleet steps_per_s=%.1f"
          % (FLEET, N, FLEET, N, FLEET, N, LAPLACE_STEPS, gpr_launches["K1"],
             gpr_launches["K2"], steps_per_s, laplace["laplace"][1]))
    print("timed at their own shapes: K4 n=128, K5 B=256 n=128, K6 wide_lsolve128 m=3968; "
          "K4-K6 launches from the exact-gram path's %d steps (no path calls them; kernel "
          "phase: %s); GPRMarginal n=%d steps_per_s=%.2f busy_share=%.4f evidence step ms "
          "murray=%.3f native=%.3f; blocked/library n=%d cholesky %.2f"
          % (MARGINAL_STEPS, " ".join("%s=%d" % kv for kv in sorted(check_calls.items())),
             MARGINAL_N, marginal["steps_per_s"], marginal["busy"], marginal["murray_ms"],
             marginal["native_ms"], max(BLOCKED_N),
             blocked[max(BLOCKED_N)]["chol_ms"] / blocked[max(BLOCKED_N)]["chol_lib_ms"]))
    ng_svgp = svgp["reg ELBO_analytic + natgrad(1.0)"]["launches"]
    print("natural gradient: K1/K2 launches a step, SVGP m=%d (B=1, ladder 3) %.3f/%.3f, fleet "
          "%dx%d (B=%d, ladder %d; the objective's own factorization and solves included) "
          "%.3f/%.3f; steps_per_s svgp %s; natgrad fleet %.1f; amortized %s"
          % (SVGP_M, ng_svgp["K1"] / SVGP_STEPS, ng_svgp["K2"] / SVGP_STEPS, FLEET, N, FLEET,
             3 * FLEET, ng_fleet["launches"]["K1"] / NATGRAD_FLEET_STEPS,
             ng_fleet["launches"]["K2"] / NATGRAD_FLEET_STEPS,
             ", ".join("%s=%.1f" % (k, v["steps_per_s"]) for k, v in svgp.items()),
             ng_fleet["steps_per_s"],
             ", ".join("%s=%.1f" % (k, v["steps_per_s"]) for k, v in amortized.items())))
    print("ep and sparse evidence: launches a step %s; sparse fleet %dx%dx%d K1=%.2f K2=%.2f "
          "K3=%.2f; host reads a step %s, sparse fleet %.1f; steps_per_s %s"
          % ("; ".join("%s fleet K1=%.2f K2=%.2f" % (k, v["launches"]["K1"] / v["steps"],
                                                     v["launches"]["K2"] / v["steps"])
                       for k, v in ep_fleets.items()),
             FLEET, SPARSE_FLEET_N, SPARSE_FLEET_M,
             sparse_fleet["launches"]["K1"] / SPARSE_FLEET_STEPS,
             sparse_fleet["launches"]["K2"] / SPARSE_FLEET_STEPS,
             sparse_fleet["launches"]["K3"] / SPARSE_FLEET_STEPS,
             ", ".join("%s=%.1f" % (k, v["reads"]) for k, v in {**ep_fleets, **sparse}.items()),
             sparse_fleet["reads"],
             ", ".join("%s=%.2f" % (k, v["steps_per_s"])
                       for k, v in {**ep_fleets, **sparse, "sparse fleet": sparse_fleet}.items())))
    bayes = later["bayes"]
    print("multiclass, samplers, bayes, smc: multiclass steps_per_s=%.3f host reads a step %.1f; "
          "BNN min bulk ESS/s %s; bayes K1/K2 launches a gradient evaluation %d/%d, min bulk "
          "ESS/s %.3f; smc stages_per_s=%.3f stages=%d"
          % (later["multiclass"]["steps_per_s"], later["multiclass"]["reads"],
             ", ".join("%s=%.2f" % (k, v["min_ess_per_s"]) for k, v in later["samplers"].items()),
             bayes["per_eval"]["K1"], bayes["per_eval"]["K2"], bayes["min_ess_per_s"],
             later["smc"]["stages_per_s"], later["smc"]["stages"]))
    fam = families
    print("families and streaming: expert init/main steps_per_s %.2f/%.2f RMSE %.4f; hetero "
          "single %.2f, fleet %.2f (K1 %.2f K2 %.2f a step), svgp %.2f; multi-output adam %.2f, "
          "natgrad %.2f (K1 %.2f K2 %.2f a step), svgp %.2f; deepgp %.2f; gplvm %.2f; "
          "streaming %.1f (in-core %.1f) busy %.4f"
          % (fam["expert"]["init"]["steps_per_s"], fam["expert"]["main"]["steps_per_s"],
             fam["expert"]["rmse"], fam["hetero"]["single"]["steps_per_s"],
             fam["hetero"]["fleet"]["steps_per_s"], fam["hetero"]["fleet"]["per_step"]["K1"],
             fam["hetero"]["fleet"]["per_step"]["K2"], fam["hetero"]["svgp"]["steps_per_s"],
             fam["multioutput"]["adam"]["steps_per_s"],
             fam["multioutput"]["natgrad"]["steps_per_s"],
             fam["multioutput"]["natgrad"]["per_step"]["K1"],
             fam["multioutput"]["natgrad"]["per_step"]["K2"],
             fam["multioutput"]["svgp"]["steps_per_s"], fam["deep"]["deepgp"]["steps_per_s"],
             fam["deep"]["gplvm"]["steps_per_s"], fam["streaming"]["steps_per_s"],
             fam["streaming"]["in_core"], fam["streaming"]["busy"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 3 and sys.argv[1] == "--examples":
        examples_main(sys.argv[2])
    else:
        main()
