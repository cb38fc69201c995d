// Triangular solves of one 128x128 float32 factor against a wide
// right-hand side on Hopper.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_wide.py (entry points
// wide_lsolve128 and wide_usolve128, kernel bodies _wide_lsolve_kernel and
// _wide_usolve_kernel). For one triangular T [128, 128] and B [128, m]
// (m a positive multiple of 128, at most 8192) it computes X [128, m] with
//   upper = 0:  L X = B, reading only the LOWER triangle of T = L;
//   upper = 1:  U X = B, reading only the UPPER triangle of T = U.
//
// Design: the grid runs over the 128-column tiles of B (m / 128 blocks of
// 128 threads), and each thread owns one right-hand-side column. Every
// block packs the triangle it reads into shared memory, 128*129/2 floats =
// 33,024 bytes, column by column: step i of the substitution reads one
// contiguous run, the pivot and the column entries that update the rows
// still open (L[i..127][i] for a lower factor, U[0..i][i] for an upper
// one). So the unread triangle is never loaded (it may hold anything, NaN
// included) and no transposed copy is formed; and the compiler loads each
// run in few wide loads (a lower factor packed by rows gave a scattered
// run, and the kernel spilled and ran 3x slower). A thread keeps its
// whole column in registers and runs the substitution column-oriented:
// once x_i is known, it stores it and updates every row still open
// (r_k -= T_ki x_i), so the updates of a step are independent FMAs rather
// than one long dependent sum. The loops are unrolled in full, which keeps
// the column's 128 values in registers; the factor entries are
// shared-memory loads that all threads of a warp make at one address (a
// broadcast). The right-hand side is read and the solution written one
// row at a time, the 32 threads of a warp on 32 neighbouring addresses.
// None of the TPU kernel's layout workarounds (8-row sublane panels,
// masked-reduce pivot extraction, the MXU update per panel) is carried
// over.
//
// Numerics: exact __fdiv_rn (the build uses no fast-math); the updates are
// plain float32 FMAs; nothing runs in TF32.
//
// Bound on the card: the work is m * 128^2 operations over about
// 4 * (2 * 128 * m + 8,256) bytes, some 30 operations a byte, under the
// card's float32 ridge; at m = 3968 the bound is about a microsecond. What
// holds the kernel back is that only m / 128 of the 132 SMs have work (one
// block of four warps each), and each warp issues its 8,128 FMAs and their
// shared-memory loads one after another. Splitting a tile over several
// blocks, or several warps over a column's rows, is left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 128;
constexpr int kMaxM = 8192;

// column i of a lower factor: L[k][i], k >= i, at lo(i, k); column i of an
// upper factor: U[k][i], k <= i, at up(i, k)
__device__ __forceinline__ int lo(int i, int k) {
  return i * kN - i * (i - 1) / 2 + (k - i);
}
__device__ __forceinline__ int up(int i, int k) { return i * (i + 1) / 2 + k; }

template <bool kUpper>
__global__ void __launch_bounds__(kN)
widesolve128_kernel(const float* __restrict__ T, const float* __restrict__ B,
                    float* __restrict__ X, int m) {
  __shared__ float s[kN * (kN + 1) / 2];

  for (int idx = threadIdx.x; idx < kN * kN; idx += kN) {
    const int i = idx / kN;
    const int j = idx - i * kN;
    if (kUpper) {
      if (j >= i) s[up(j, i)] = T[idx];
    } else {
      if (j <= i) s[lo(j, i)] = T[idx];
    }
  }
  __syncthreads();

  const size_t col = static_cast<size_t>(blockIdx.x) * kN + threadIdx.x;
  const size_t ld = static_cast<size_t>(m);
  float r[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = B[i * ld + col];

  // each solved row is stored at once, so its register is free for the
  // rest of the chain (kept to the end, they made the compiler spill)
  if (!kUpper) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float x = __fdiv_rn(r[i], s[lo(i, i)]);
      X[i * ld + col] = x;
#pragma unroll
      for (int k = i + 1; k < kN; ++k) r[k] = fmaf(-s[lo(i, k)], x, r[k]);
    }
  } else {
#pragma unroll
    for (int i = kN - 1; i >= 0; --i) {
      const float x = __fdiv_rn(r[i], s[up(i, i)]);
      X[i * ld + col] = x;
#pragma unroll
      for (int k = 0; k < i; ++k) r[k] = fmaf(-s[up(i, k)], x, r[k]);
    }
  }
}

}  // namespace

// T: [128, 128]; B and X: [128, m]; float32, contiguous, on the current
// device; X must not overlap T or B. m is a positive multiple of 128, at
// most 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int widesolve128_launch(const float* T, const float* B, float* X,
                                   int m, int upper, void* stream) {
  if (m <= 0 || m % kN != 0 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (upper) {
    widesolve128_kernel<true><<<m / kN, kN, 0, st>>>(T, B, X, m);
  } else {
    widesolve128_kernel<false><<<m / kN, kN, 0, st>>>(T, B, X, m);
  }
  return static_cast<int>(cudaGetLastError());
}
