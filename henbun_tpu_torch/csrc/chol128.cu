// Batched lower Cholesky factorization of small float32 matrices on Hopper.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_chol.py::cholesky128_vbatched
// (kernel body _chol_kernel_vbatch), and through their own entries in
// ops/cuda_chol.py cholesky128 and cholesky128_batched. It computes, for
// each matrix A_b of a [B, n, n] batch (n <= 128), the lower factor L_b
// with A_b = L_b L_b^T.
//
// Design: one thread block of 256 threads per matrix (grid = B, any B).
// The lower triangle is copied with cp.async (every thread's loads in
// flight at once) into dynamic shared memory as a square padded to whole
// 32-column panels with the identity (np = n rounded up to 32; at most
// 128 x 129 floats), row i at s[i * ld], ld = np | 1: with an odd row
// stride the 32 lanes of a warp that walk a column hit 32 banks. The
// factorization is blocked and right-looking, over 32-column panels, three
// block barriers a panel (12 at n = 128, against 3n for a column at a
// time): one warp factors the diagonal block in registers with shuffles as
// straight-line code, the rows below are solved a thread a row, and all
// 256 threads apply a register-tiled trailing update. That factorization
// lives in panel_chol.cuh, which newton128.cu (K3) shares. No TPU layout
// workaround is kept: no padding to 128, no upper factor to transpose, no
// 8-row panels, no masked reductions to pull out a pivot.
//
// Several small matrices in one block (one warp each for n <= 32) were not
// chosen: the paths that call the kernel give it n = 40, 60 and 128, and
// at B = 16 a block a matrix already leaves most SMs idle for any layout.
//
// Numerics: exact __fsqrt_rn and __fdiv_rn (the build uses no fast-math),
// and the updates are plain float32 FMAs; nothing runs in TF32, so the
// tensor cores are out of reach and the levers are latency ones: few
// barriers, warp-synchronous steps, operands on chip. A zero dividend is
// kept off __fdiv_rn's slow path (five times the fast one on the H100).
//
// Contract:
//   * only the lower triangle of A is read (the upper one may hold anything);
//   * zeros are written above the diagonal;
//   * a matrix whose pivot is not positive, or is NaN, in any panel gets an
//     all-NaN factor (as jnp.linalg.cholesky), and the other matrices of
//     the batch are untouched, so safe_cholesky can escalate the jitter per
//     matrix.
//
// Bound on the card: a factorization is n^3 / 3 FMAs (0.7 M at n = 128)
// on 0.1 MB, far under both of the card's roofs at the paths' batch sizes.
// What bounds it is the dependent chain: n pivots, each a shuffle, a square
// root and a divide inside one warp (about 250 cycles a pivot, measured
// with clock64 at n = 128: 8,000 of a full panel's 13,000-24,000), the
// block barriers between panels, and that only B of the 132 SMs have work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "panel_chol.cuh"

namespace {

using panel_chol::kPanel;
using panel_chol::kThreads;
constexpr int kMaxN = 128;
constexpr int kWarps = kThreads / 32;

// n rounded up to whole panels
__host__ __device__ __forceinline__ int padded(int n) { return (n + kPanel - 1) & ~(kPanel - 1); }

// Shared memory of one block: the padded matrix, then the panel buffer
// (16-byte aligned), in floats.
__host__ __device__ __forceinline__ int panel_offset(int n) {
  return (padded(n) * (padded(n) | 1) + 3) & ~3;
}
__host__ __device__ __forceinline__ int smem_floats(int n) {
  return panel_offset(n) + panel_chol::panel_floats(n);
}

__global__ void __launch_bounds__(kThreads, 2)
chol128_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  float* pb = s + panel_offset(n);
  __shared__ int failed;

  const int np = padded(n);
  const int ld = np | 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const float* a = A + offset;
  float* l = L + offset;

  // rows n .. np - 1 pad the matrix to whole panels with the identity
  for (int i = warp; i < np; i += kWarps) {
    for (int j = lane; j <= i; j += 32) {
      if (i < n) {
        __pipeline_memcpy_async(s + i * ld + j, a + i * n + j, 4);
      } else {
        s[i * ld + j] = i == j ? 1.f : 0.f;
      }
    }
  }
  __pipeline_commit();
  if (tid == 0) failed = 0;
  __pipeline_wait_prior(0);
  __syncthreads();

  const bool bad = panel_chol::factor<6, false>(s, ld, pb, n, np, &failed);

  const float nan = __int_as_float(0x7fc00000);
  for (int i = warp; i < n; i += kWarps) {
    for (int j = lane; j < n; j += 32) {
      l[i * n + j] = bad ? nan : (j <= i ? s[i * ld + j] : 0.f);
    }
  }
}

}  // namespace

// A, L: [batch, n, n] float32, contiguous, on the current device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chol128_launch(const float* A, float* L, int batch, int n,
                              void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(float)) * smem_floats(n);
  const cudaError_t err = cudaFuncSetAttribute(
      chol128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol128_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}
