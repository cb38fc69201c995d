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
// time):
//   1. one warp factors the panel's 32 x 32 diagonal block, each lane
//      holding one of its rows in registers: the pivot is broadcast by
//      __shfl_sync, every lane takes its square root, scales its own entry
//      and applies the rank-1 update to its row, with no block barrier.
//      Lane j + 1 forms the next pivot from its own entries, so the chain
//      from pivot to pivot is a shuffle, a square root, a divide and an
//      FMA. The padding makes every panel whole, so the step is straight-
//      line code: with no branch around the shuffles the compiler needs no
//      reconvergence code at each one;
//   2. the rows below the panel, one thread a row (up to 96), solve
//      against the diagonal block (L21 = A21 L11^-T), the row in registers
//      and L11 read as shared-memory broadcasts; each thread also copies
//      its finished row to a panel buffer with a 16-byte row stride;
//   3. all 256 threads apply the panel to the trailing lower triangle,
//      A22 -= L21 L21^T, as a register-tiled float32 FMA product: thread
//      (ty, tx) of a 16 x 16 grid owns rows ty + 16a and columns tx + 16b,
//      b <= a (the pairs that can lie on or below the diagonal), so no
//      index is divided and no tile above the diagonal is computed. Its
//      operands come from the panel buffer four columns to a 16-byte load
//      (a stride of 36 floats keeps eight rows' loads on distinct banks).
//      The tile's span (1-6 rows and columns) is a template argument chosen
//      from the trailing size, so no FMA runs on padding.
// Steps 2 and 3 take the real rows only. Every entry receives its updates
// in the plain version's order (panel by panel, column by column). No TPU
// layout workaround is kept: no padding to 128, no upper factor to
// transpose, no 8-row panels, no masked reductions to pull out a pivot.
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

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;        // a panel is as wide as a warp
constexpr int kGrid = 16;         // the trailing update's kGrid x kGrid threads
constexpr int kPld = kPanel + 4;  // the panel buffer's row stride
constexpr unsigned kAll = 0xffffffffu;

// a / b rounded to nearest. A zero dividend would take __fdiv_rn's slow
// path; it is divided as 1 and the zero given the quotient's sign instead.
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.f && (b < 0.f || b > 0.f);
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? a * q : q;
}

// Step 3 on the m x m trailing triangle at row and column k1: each thread
// owns rows ty + 16a and columns tx + 16b, a, b < kSpan, b <= a, and
// subtracts the panel's 32 columns (the buffer pb, row r at pb[r * kPld])
// one at a time.
template <int kSpan>
__device__ __forceinline__ void trailing_update(float* s, int ld, const float* pb, int k1,
                                                int m) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & (kGrid - 1);
  float acc[kSpan][kSpan];
#pragma unroll
  for (int a = 0; a < kSpan; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int r = ty + kGrid * a, c = tx + kGrid * b;
      acc[a][b] = (r < m && c <= r) ? s[(k1 + r) * ld + k1 + c] : 0.f;
    }
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int p = 0; p < kPanel; p += 4) {
    float4 lr[kSpan], lc[kSpan];
#pragma unroll
    for (int a = 0; a < kSpan; ++a) {
      const int r = ty + kGrid * a, c = tx + kGrid * a;
      lr[a] = r < m ? *reinterpret_cast<const float4*>(pb + r * kPld + p) : zero4;
      lc[a] = c < m ? *reinterpret_cast<const float4*>(pb + c * kPld + p) : zero4;
    }
#pragma unroll
    for (int a = 0; a < kSpan; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        acc[a][b] = fmaf(-lr[a].x, lc[b].x, acc[a][b]);
        acc[a][b] = fmaf(-lr[a].y, lc[b].y, acc[a][b]);
        acc[a][b] = fmaf(-lr[a].z, lc[b].z, acc[a][b]);
        acc[a][b] = fmaf(-lr[a].w, lc[b].w, acc[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kSpan; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int r = ty + kGrid * a, c = tx + kGrid * b;
      if (r < m && c <= r) s[(k1 + r) * ld + k1 + c] = acc[a][b];
    }
  }
}

// n rounded up to whole panels
__host__ __device__ __forceinline__ int padded(int n) { return (n + kPanel - 1) & ~(kPanel - 1); }

// Shared memory of one block: the padded matrix, then the panel buffer
// (16-byte aligned), in floats.
__host__ __device__ __forceinline__ int panel_offset(int n) {
  return (padded(n) * (padded(n) | 1) + 3) & ~3;
}
__host__ __device__ __forceinline__ int smem_floats(int n) {
  return panel_offset(n) + (n > kPanel ? (n - kPanel) * kPld : 0);
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

  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int k1 = k0 + kPanel;  // the first row below the panel

    // 1. the diagonal block, one warp, lane = row k0 + lane; straight-line
    // code (no branch, so the compiler knows the warp converged at every
    // shuffle): a failed pivot is recorded and the steps after it run on a
    // pivot of 1
    if (warp == 0) {
      float* row = s + (k0 + lane) * ld + k0;
      float r[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) r[c] = c <= lane ? row[c] : 0.f;
      bool ok = true;
      float d = __shfl_sync(kAll, r[0], 0);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        ok = ok && d > 0.f;  // not positive, or NaN, fails
        const float piv = __fsqrt_rn(ok ? d : 1.f);
        // column j: the pivot in lane j, L[l][j] below it, 0 above (a
        // lane's entries above the diagonal hold partial sums that are
        // never stored, and are zeroed here before they could be divided)
        const float q = div_rn(lane > j ? r[j] : 0.f, piv);
        r[j] = lane == j ? piv : q;
        if (j + 1 < kPanel) {
          // lane j + 1's own update of its diagonal entry: the next pivot
          d = __shfl_sync(kAll, fmaf(-r[j], r[j], r[j + 1]), j + 1);
        }
#pragma unroll
        for (int c = j + 1; c < kPanel; ++c) {
          r[c] = fmaf(-r[j], __shfl_sync(kAll, r[j], c), r[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        if (c <= lane) row[c] = r[c];
      }
      if (!ok && lane == 0) failed = 1;
    }
    __syncthreads();
    if (failed) break;  // uniform: every thread reads it after the barrier
    const int m = n - k1;
    if (m <= 0) break;

    // 2. the real rows below the panel against the diagonal block
    if (tid < m) {
      float* row = s + (k1 + tid) * ld + k0;
      const float* diag = s + k0 * ld + k0;
      float x[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) x[c] = row[c];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        x[j] = div_rn(x[j], diag[j * ld + j]);
#pragma unroll
        for (int c = j + 1; c < kPanel; ++c) x[c] = fmaf(-x[j], diag[c * ld + j], x[c]);
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c) row[c] = x[c];
      float4* dst = reinterpret_cast<float4*>(pb + tid * kPld);
#pragma unroll
      for (int c = 0; c < kPanel; c += 4) {
        dst[c / 4] = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
      }
    }
    __syncthreads();

    // 3. the trailing triangle, all threads
    switch ((m + kGrid - 1) / kGrid) {
      case 1: trailing_update<1>(s, ld, pb, k1, m); break;
      case 2: trailing_update<2>(s, ld, pb, k1, m); break;
      case 3: trailing_update<3>(s, ld, pb, k1, m); break;
      case 4: trailing_update<4>(s, ld, pb, k1, m); break;
      case 5: trailing_update<5>(s, ld, pb, k1, m); break;
      default: trailing_update<6>(s, ld, pb, k1, m); break;
    }
    __syncthreads();
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int i = warp; i < n; i += kWarps) {
    for (int j = lane; j < n; j += 32) {
      l[i * n + j] = failed ? nan : (j <= i ? s[i * ld + j] : 0.f);
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
