"""Where a small-matrix kernel's time goes inside its block, on the card.

    python -m henbun_tpu_torch.utils.phase_trace

Builds a traced copy of ``csrc/chol128.cu`` and ``csrc/trisolve128.cu``:
thread 0 of each of the first 64 blocks writes ``clock64()`` into a
``__device__`` array when the kernel starts and after every
``__syncthreads()``, and the host reads it back. So each phase between two
barriers (the loads; for the Cholesky each panel's diagonal block, rows
below and trailing update; for the solve each block's diagonal solve and
update) gets its cycles in block 0. It also times dependent chains of the
few operations that bound the kernels: ``__fdiv_rn`` with a nonzero and a
zero dividend, ``__fsqrt_rn``, ``__shfl_sync``, an FMA. Prints one line a
shape, with the card's name, power limit and SM clock.

Needs a CUDA device and ``nvcc``; the traced libraries go to
``build/henbun_tpu_torch/trace/``. Nothing here runs on a training path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops import _build

OUT = os.path.join(_build.BUILD_DIR, "trace")
MARKS = 64
_HEAD = """
__device__ long long g_trace[64 * %d];
extern "C" int get_trace(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
#define MARK() do { if (threadIdx.x == 0 && blockIdx.x < 64 && mark < %d) \\
  g_trace[blockIdx.x * %d + mark++] = clock64(); } while (0)
""" % (MARKS, MARKS, MARKS)

_MICRO = r"""
#include <cuda_runtime.h>
__device__ float g_sink[32];
__device__ long long g_cyc[5];
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
extern "C" int run_micro(long long* out, int n) {
  micro<<<1, 32>>>(1.2345f, 1.0001f, n);
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(long long) * 5);
}
"""


def traced_source(name):
    """csrc/<name>.cu with a MARK() at the kernel's start (the line that
    reads threadIdx.x into tid) and after every __syncthreads()."""
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        text = f.read()
    start = "  const int tid = threadIdx.x;\n"
    if text.count(start) != 1:
        raise RuntimeError("csrc/%s.cu: no single '%s' to mark the start at" % (name, start.strip()))
    text = text.replace("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + _HEAD, 1)
    text = text.replace(start, start + "  int mark = 0;\n  MARK();\n")
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
    """Block 0's cycles between consecutive marks."""
    buf = np.zeros(64 * MARKS, dtype=np.int64)
    err = lib.get_trace(ctypes.c_void_p(buf.ctypes.data))
    if err != 0:
        raise RuntimeError("reading the trace failed: cudaError %d" % err)
    t = buf[:MARKS]
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_trace needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    libs = _build_all({"chol128": traced_source("chol128"),
                       "trisolve128": traced_source("trisolve128"), "micro": _MICRO})
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    out = np.zeros(5, dtype=np.int64)
    chain = 1024
    err = libs["micro"].run_micro(ctypes.c_void_p(out.ctypes.data), chain)
    if err != 0:
        raise RuntimeError("micro failed: cudaError %d" % err)
    print("cycles an operation, %d-long dependent chains: __fdiv_rn %.1f, __fdiv_rn of 0 %.1f, "
          "__fsqrt_rn + add %.1f, __shfl_sync * mul %.1f, fma %.1f" % ((chain,) + tuple(out / chain)))

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


def _split(phases, k):
    """(the first phase, the rest in groups of k)."""
    rest = phases[1:]
    return phases[0], [rest[i:i + k] for i in range(0, len(rest), k)]


if __name__ == "__main__":
    main()
