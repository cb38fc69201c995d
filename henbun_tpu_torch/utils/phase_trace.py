"""Where a small-matrix kernel's time goes inside its block, on the card.

    python -m henbun_tpu_torch.utils.phase_trace

Builds a traced copy of every kernel source, ``csrc/chol128.cu``,
``trisolve128.cu``, ``newton128.cu`` and ``widesolve128.cu``: thread 0 of
each of the first 64 blocks writes ``clock64()`` into a ``__device__``
array when a kernel starts, after every ``__syncthreads()`` (also those in
helper functions: the mark counter is a shared-memory word) and when it
ends, and the host reads it back. So each phase between two barriers (the
loads; for the Cholesky each panel's diagonal block, rows below and
trailing update; for the solves each block's diagonal solve and update;
for the Newton loop each step of three iterations, the first cold) gets
its cycles in block 0; the Cholesky also runs on K3's Newton systems, to
tell a kernel's code from its data. It also times dependent chains of the
few operations that bound the kernels: ``__fdiv_rn`` with a nonzero and a
zero dividend and with dividends from 1 down to 2^-120 (where its slow
path starts), ``__fsqrt_rn``, ``__shfl_sync``, an FMA. Prints one line a
shape, with the card's name, power limit and SM clock.

Needs a CUDA device and ``nvcc``; the traced libraries go to
``build/henbun_tpu_torch/trace/``. Nothing here runs on a training path.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_wide import tile_cols

OUT = os.path.join(_build.BUILD_DIR, "trace")
MARKS = 512  # marks a block: one Newton iteration of the column-loop design has 2m + 13
_HEAD = """
__device__ long long g_trace[64 * %d];
__shared__ int g_mark;
extern "C" int get_trace(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
extern "C" int clear_trace() {
  void* p;
  cudaError_t e = cudaGetSymbolAddress(&p, g_trace);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_trace)));
}
#define MARK() do { if (threadIdx.x == 0 && blockIdx.x < 64) { \\
  const long long t_ = clock64(); const int k_ = g_mark; \\
  if (k_ < %d) g_trace[blockIdx.x * %d + k_] = t_; g_mark = k_ + 1; } } while (0)
""" % (MARKS, MARKS, MARKS)

_MICRO = r"""
#include <cuda_runtime.h>
__device__ float g_sink[32];
__device__ long long g_cyc[5];
__device__ long long g_div[16];
__global__ void micro(float a, float b, int n) {
  const int lane = threadIdx.x;
  float x = a + lane * 1e-6f, y = a, z = a, w = a, u = a;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = __fdiv_rn(x, b);
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) u = __fdiv_rn(u * 0.f, b) + 0.f;
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) y = __fsqrt_rn(y) + 1.0f;
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) w = __shfl_sync(0xffffffffu, w, (lane + 1) & 31) * b;
  long long t4 = clock64();
  for (int i = 0; i < n; ++i) z = fmaf(z, b, 1e-3f);
  long long t5 = clock64();
  g_sink[lane] = x + y + z + w + u;
  if (lane == 0) {
    g_cyc[0] = t1 - t0; g_cyc[1] = t2 - t1; g_cyc[2] = t3 - t2; g_cyc[3] = t4 - t3;
    g_cyc[4] = t5 - t4;
  }
}
// __fdiv_rn with a dividend of magnitude 2^-e, e = 8 k (k = 0 .. 15), in a
// dependent chain (the dividend is c + 0 * the last quotient)
__global__ void micro_div(float b, int n) {
  float c = 1.25f;
  for (int k = 0; k < 16; ++k) {
    float q = 0.f;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) q = __fdiv_rn(c + q * 0.f, b);
    long long t1 = clock64();
    g_sink[threadIdx.x] += q;
    if (threadIdx.x == 0) g_div[k] = t1 - t0;
    c *= 0x1p-8f;
  }
}
extern "C" int run_micro(long long* out, long long* div, int n) {
  micro<<<1, 32>>>(1.2345f, 1.0001f, n);
  micro_div<<<1, 32>>>(1.0001f, n);
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(div, g_div, sizeof(long long) * 16);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(long long) * 5);
}
"""


def _kernel_bodies(text):
    """(open, close) offsets of the braces around each __global__ function's
    body; // comments are skipped when braces are counted."""
    spans = []
    for match in re.finditer(r"__global__[^{;]*\{", text):
        depth, i = 0, match.end() - 1
        while True:
            if text.startswith("//", i):
                i = text.index("\n", i)
                continue
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        spans.append((match.end() - 1, i))
    return spans


def expanded_source(name):
    """csrc/<name>.cu with each csrc header it includes (#include "x.cuh")
    written in place, so that the header's barriers are traced too."""
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        text = f.read()
    for header in _build.headers():
        line = '#include "%s"\n' % header
        if line in text:
            with open(os.path.join(_build.CSRC, header)) as f:
                text = text.replace(line, f.read().replace("#pragma once\n", ""), 1)
    return text


def traced_source(name):
    """csrc/<name>.cu, its headers in place, with a MARK() at each kernel's
    start and end and after every __syncthreads()."""
    text = expanded_source(name)
    spans = _kernel_bodies(text)
    if not spans or "#include <cuda_runtime.h>\n" not in text:
        raise RuntimeError("csrc/%s.cu: no __global__ kernel or no cuda_runtime.h include" % name)
    for open_, close in reversed(spans):
        text = (text[:open_ + 1] + "\n  if (threadIdx.x == 0) g_mark = 0;\n  MARK();\n"
                + text[open_ + 1:close] + "  MARK();\n" + text[close:])
    text = text.replace("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + _HEAD, 1)
    return text.replace("__syncthreads();", "__syncthreads(); MARK();")


def _build_all(sources):
    """{name: ctypes library} for {name: CUDA source text}, one nvcc each,
    all started together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(OUT, name + ".cu")
        with open(src, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path()] + _build.NVCC_FLAGS + ["-o", os.path.join(OUT, name + ".so"), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name, log))
        libs[name] = ctypes.CDLL(os.path.join(OUT, name + ".so"))
    return libs


def _phases(lib):
    """Block 0's cycles between consecutive marks of the last launch (the
    trace is cleared after it is read)."""
    buf = np.zeros(64 * MARKS, dtype=np.int64)
    err = lib.get_trace(ctypes.c_void_p(buf.ctypes.data))
    if err != 0:
        raise RuntimeError("reading the trace failed: cudaError %d" % err)
    t = buf[:MARKS]
    err = lib.clear_trace()
    if err != 0:
        raise RuntimeError("clearing the trace failed: cudaError %d" % err)
    return np.diff(t[t != 0]).tolist()


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    A = (Q * np.logspace(-2, 0, n)) @ np.swapaxes(Q, -1, -2)
    return torch.tensor(A.astype(np.float32), device="cuda")


def _lower(B, n, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(B, n, n)) * (0.5 / np.sqrt(n)))
    L[:, np.arange(n), np.arange(n)] = rng.uniform(1.0, 2.0, size=(B, n))
    return torch.tensor(L.astype(np.float32), device="cuda")


def _newton_batch(tag, B, n, seed):
    """Square K3 inputs: RBF factors of sorted inputs on [0, 6], sine
    targets with outliers (labels y > 0 for bernoulli_logit)."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (B, n, 1)), axis=1)
    K = np.exp(-0.5 * (X - np.swapaxes(X, 1, 2)) ** 2 / 0.7 ** 2) + 1e-4 * np.eye(n)
    y = np.sin(X) + 0.1 * rng.standard_normal((B, n, 1))
    y[:, ::7] += 2.0
    if tag == 1:
        y = (y > 0).astype(np.float64)
    var = 0.15 + 0.05 * (np.arange(B) % 4)
    return tuple(torch.tensor(a.astype(np.float32), device="cuda")
                 for a in (np.linalg.cholesky(K), y, var))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_trace needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = _build_all(dict({name: traced_source(name) for name in _build.sources()},
                           micro=_MICRO))
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    out = np.zeros(5, dtype=np.int64)
    div = np.zeros(16, dtype=np.int64)
    chain = 1024
    err = libs["micro"].run_micro(ctypes.c_void_p(out.ctypes.data),
                                  ctypes.c_void_p(div.ctypes.data), chain)
    if err != 0:
        raise RuntimeError("micro failed: cudaError %d" % err)
    print("cycles an operation, %d-long dependent chains: __fdiv_rn %.1f, __fdiv_rn of 0 %.1f, "
          "__fsqrt_rn + add %.1f, __shfl_sync * mul %.1f, fma %.1f" % ((chain,) + tuple(out / chain)))
    print("__fdiv_rn by 1.0001 of a dividend 1.25 * 2^-e, cycles: %s" % ", ".join(
        "e=%d %.1f" % (8 * k, c / chain) for k, c in enumerate(div)))

    chol = libs["chol128"].chol128_launch
    chol.argtypes = [P, P, I, I, P]
    for B, n in ((16, 40), (16, 60), (1, 128), (16, 128), (256, 128)):
        A = _spd(B, n, seed=n)
        L = torch.empty_like(A)
        err = chol(A.data_ptr(), L.data_ptr(), B, n, stream)
        torch.cuda.synchronize()
        if err != 0 or not torch.isfinite(L).all():
            raise RuntimeError("traced chol128 failed at B=%d n=%d (%d)" % (B, n, err))
        print("chol128 B=%d n=%d cycles: load %s; then per panel [diagonal block, rows below, "
              "trailing update]: %s" % (B, n, *_split(_phases(libs["chol128"]), 3)))
    # the same kernel on K3's Newton systems, I + Lk^T |W| Lk of smooth kernels' factors
    for n in (40, 128):
        Lk = _newton_batch(1, 16, n, seed=n)[0]
        A = torch.eye(n, device="cuda") + Lk.mT @ (0.5 * Lk)
        L = torch.empty_like(A)
        err = chol(A.data_ptr(), L.data_ptr(), 16, n, stream)
        torch.cuda.synchronize()
        if err != 0 or not torch.isfinite(L).all():
            raise RuntimeError("traced chol128 failed on a Newton system at n=%d (%d)" % (n, err))
        print("chol128 on Newton systems B=16 n=%d cycles: load %s; then per panel [diagonal "
              "block, rows below, trailing update]: %s" % (n, *_split(_phases(libs["chol128"]), 3)))

    solve = libs["trisolve128"].trisolve128_launch
    solve.argtypes = [P, P, P, I, I, I, I, P]
    for B, n, m in ((16, 40, 40), (16, 40, 1), (16, 60, 60), (16, 128, 128), (16, 128, 1)):
        Lf = _lower(B, n, seed=n + m)
        R = torch.randn(B, n, m, device="cuda")
        for transpose in (0, 1):
            X = torch.empty_like(R)
            err = solve(Lf.data_ptr(), R.data_ptr(), X.data_ptr(), B, n, m, transpose, stream)
            torch.cuda.synchronize()
            if err != 0 or not torch.isfinite(X).all():
                raise RuntimeError("traced trisolve128 failed at B=%d n=%d m=%d" % (B, n, m))
            print("trisolve128 B=%d n=%d m=%d transpose=%d cycles: load %s; then per block "
                  "[diagonal solve, update]: %s"
                  % (B, n, m, transpose, *_split(_phases(libs["trisolve128"]), 2)))

    newton = libs["newton128"].newton128_launch
    newton.argtypes = [P, P, P, P, I, I, I, I, I, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, P]
    for tag, B, n in ((1, 16, 40), (0, 16, 60), (1, 16, 128), (0, 16, 128)):
        Lk, y, var = _newton_batch(tag, B, n, seed=n)
        v = torch.empty(B, n, 1, device="cuda")
        # three iterations: the first runs its code cold, the others warm
        # (the Student-t constant is immaterial to the timing)
        err = newton(Lk.data_ptr(), y.data_ptr(), var.data_ptr(), v.data_ptr(), B, n, n, 3, tag,
                     3.0, -1.0, 1e-6, stream)
        torch.cuda.synchronize()
        if err != 0 or not torch.isfinite(v).all():
            raise RuntimeError("traced newton128 failed at tag=%d B=%d n=%d" % (tag, B, n))
        phases = _phases(libs["newton128"])
        k = (len(phases) - 2) // 3  # load, three iterations, the store
        print("newton128 tag=%d B=%d n=m=%d cycles: load %d; iterations %s (%s in all); store %d"
              % (tag, B, n, phases[0], [phases[1 + i * k:1 + (i + 1) * k] for i in range(3)],
                 [sum(phases[1 + i * k:1 + (i + 1) * k]) for i in range(3)], phases[-1]))

    wide = libs["widesolve128"].widesolve128_launch
    wide.argtypes = [P, P, P, I, I, I, P]
    for m in (128, 1024, 3968, 8192):
        Lf = _lower(1, 128, seed=m)[0]
        R = torch.randn(128, m, device="cuda")
        for upper in (0, 1):
            T = Lf.mT.contiguous() if upper else Lf
            X = torch.empty_like(R)
            err = wide(T.data_ptr(), R.data_ptr(), X.data_ptr(), m, upper, tile_cols(m), stream)
            torch.cuda.synchronize()
            if err != 0 or not torch.isfinite(X).all():
                raise RuntimeError("traced widesolve128 failed at m=%d upper=%d" % (m, upper))
            phases = _phases(libs["widesolve128"])
            print("widesolve128 m=%d upper=%d cols=%d cycles: %d in all; load %s; then per "
                  "block [diagonal solve, update]: %s"
                  % (m, upper, tile_cols(m), sum(phases), *_split(phases, 2)))


def _split(phases, k):
    """(the first phase, the rest in groups of k)."""
    rest = phases[1:]
    return phases[0], [rest[i:i + k] for i in range(0, len(rest), k)]


if __name__ == "__main__":
    main()
