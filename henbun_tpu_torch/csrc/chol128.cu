// Batched lower Cholesky factorization of small float32 matrices on Hopper.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_chol.py::cholesky128_vbatched
// (kernel body _chol_kernel_vbatch). It computes, for each matrix A_b of a
// [B, n, n] batch (n <= 128), the lower factor L_b with A_b = L_b L_b^T.
//
// Design: one thread block per matrix (grid = B, any B). The lower triangle
// of the matrix lives packed in shared memory, row-major over the triangle
// (at most 128*129/2 floats = 33,024 bytes, under the 48 KB static limit).
// The factorization is right-looking, one column j at a time:
//   1. one thread takes the pivot sqrt(A_jj);
//   2. the threads scale column j below the diagonal by 1 / L_jj;
//   3. the threads apply the rank-1 update A_rc -= L_rj L_cj to the trailing
//      lower triangle (j < c <= r < n),
// with a __syncthreads between the steps. No TPU layout workaround is kept:
// no padding to 128, no upper factor to transpose, no 8-row panels, no
// masked reductions to pull out a pivot.
//
// Numerics: exact __fsqrt_rn / __fdiv_rn (the build uses no fast-math), and
// the update is plain float32 arithmetic; nothing runs in TF32.
//
// Contract:
//   * only the lower triangle of A is read (the upper one may hold anything);
//   * zeros are written above the diagonal;
//   * a matrix whose pivot is not positive, or is NaN, gets an all-NaN
//     factor (as jnp.linalg.cholesky), and the other matrices of the batch
//     are untouched, so safe_cholesky can escalate the jitter per matrix.
//
// Bound on the card: at the training path's shapes (B = 16, n = 40: about
// 0.34 MFLOP and 0.2 MB) neither FLOPs nor bytes bound it. The n-step chain
// of __syncthreads inside each block and the launch latency do, and only B
// of the 132 SMs have work. Making it fast (several matrices per block,
// warp-level column steps, one launch for several factorizations) is left
// to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void __launch_bounds__(kThreads)
chol128_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  __shared__ float s[kMaxN * (kMaxN + 1) / 2];
  __shared__ int failed;

  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const float* a = A + offset;
  float* l = L + offset;
  const int nn = n * n;

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    if (j <= i) s[tri(i, j)] = a[idx];
  }
  if (threadIdx.x == 0) failed = 0;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0) {
      const float d = s[tri(j, j)];
      if (d > 0.f) {
        s[tri(j, j)] = __fsqrt_rn(d);
      } else {  // not positive, or NaN
        failed = 1;
      }
    }
    __syncthreads();
    if (failed) break;  // uniform: every thread reads it after the barrier

    const float piv = s[tri(j, j)];
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) {
      s[tri(i, j)] = __fdiv_rn(s[tri(i, j)], piv);
    }
    __syncthreads();

    const int m = n - j - 1;
    for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
      const int r = j + 1 + t / m;
      const int c = j + 1 + t % m;
      if (c <= r) s[tri(r, c)] -= s[tri(r, j)] * s[tri(c, j)];
    }
    __syncthreads();
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    l[idx] = failed ? nan : (j <= i ? s[tri(i, j)] : 0.f);
  }
}

}  // namespace

// A, L: [batch, n, n] float32, contiguous, on the current device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chol128_launch(const float* A, float* L, int batch, int n,
                              void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  chol128_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}
