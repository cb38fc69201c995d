// Batched triangular solves against small float32 factors on Hopper.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_solve.py::tri_solve128_vbatched
// (kernel bodies _lsolve_kernel_vbatch and _usolve_kernel_vbatch). For each
// lower-triangular L_b of a [B, n, n] batch and right-hand side R_b of a
// [B, n, m] batch (n, m <= 128) it computes X_b with
//   transpose = 0:  L_b   X_b = R_b   (forward substitution),
//   transpose = 1:  L_b^T X_b = R_b   (back substitution).
//
// Design: one thread block per matrix (grid = B, any B) and one thread per
// right-hand-side column. The lower triangle of L lives packed in shared
// memory (at most 33,024 bytes). Both modes read that same triangle:
// back substitution reads L[k][i] for k > i directly, so no transposed copy
// of L is ever formed, and the upper triangle of L is never read (it may
// hold anything, NaN included). Each thread walks its column of X in order
// and keeps the solved entries in the output buffer, where the threads of a
// warp touch neighbouring addresses; every thread of a warp reads the same
// L entry, which shared memory broadcasts.
//
// Numerics: exact __fdiv_rn (no fast-math); nothing runs in TF32.
//
// Bound on the card: at the training path's shapes (B = 16, n = m = 40:
// about 1 MFLOP and 0.3 MB per solve) neither FLOPs nor bytes bound it.
// The n-long dependency chain of each column and the launch latency do, and
// only B of the 132 SMs have work. Left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void __launch_bounds__(kMaxN)
trisolve128_kernel(const float* __restrict__ Lm, const float* __restrict__ R,
                   float* X, int n, int m, int transpose) {
  __shared__ float s[kMaxN * (kMaxN + 1) / 2];

  const float* l = Lm + static_cast<size_t>(blockIdx.x) * n * n;
  const float* r = R + static_cast<size_t>(blockIdx.x) * n * m;
  float* x = X + static_cast<size_t>(blockIdx.x) * n * m;
  const int nn = n * n;

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    if (j <= i) s[tri(i, j)] = l[idx];
  }
  __syncthreads();

  const int col = threadIdx.x;
  if (col >= m) return;

  if (!transpose) {
    for (int i = 0; i < n; ++i) {
      float acc = r[i * m + col];
      for (int k = 0; k < i; ++k) acc -= s[tri(i, k)] * x[k * m + col];
      x[i * m + col] = __fdiv_rn(acc, s[tri(i, i)]);
    }
  } else {
    for (int i = n - 1; i >= 0; --i) {
      float acc = r[i * m + col];
      for (int k = i + 1; k < n; ++k) acc -= s[tri(k, i)] * x[k * m + col];
      x[i * m + col] = __fdiv_rn(acc, s[tri(i, i)]);
    }
  }
}

}  // namespace

// L: [batch, n, n], R and X: [batch, n, m], float32, contiguous, on the
// current device; X must not overlap L or R. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int trisolve128_launch(const float* L, const float* R, float* X,
                                  int batch, int n, int m, int transpose,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || m <= 0 || m > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((m + 31) / 32) * 32;
  trisolve128_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      L, R, X, n, m, transpose);
  return static_cast<int>(cudaGetLastError());
}
