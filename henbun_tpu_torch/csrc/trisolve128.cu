// Batched triangular solves against small float32 factors on Hopper.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_solve.py::tri_solve128_vbatched
// (kernel bodies _lsolve_kernel_vbatch and _usolve_kernel_vbatch). For each
// lower-triangular L_b of a [B, n, n] batch and right-hand side R_b of a
// [B, n, m] batch (n, m <= 128) it computes X_b with
//   transpose = 0:  L_b   X_b = R_b   (forward substitution),
//   transpose = 1:  L_b^T X_b = R_b   (back substitution).
//
// Design: one thread block of 256 threads per matrix (grid = B, any B).
// Both the factor and the [n, m] solution are copied with cp.async into
// dynamic shared memory, padded to whole 32-row blocks (np = n rounded up
// to 32; odd row strides np | 1 and m | 1; at most 132,096 bytes at
// n = m = 128), so no solved entry goes back to device memory inside the
// chain. Only L's lower triangle is loaded, and it is laid out by the step
// that reads it: row i of the stored matrix T holds the coefficients of
// unknown i on the other rows, T[i][k] = L[k][i] (k >= i) for the forward
// solve, so L is transposed on load, and T[i][k] = L[i][k] (k <= i) for
// the transposed solve, L as it is. Every step of either mode then reads
// one contiguous run, the upper triangle of L is never read (it may hold
// NaN) and no transposed copy of the matrix is formed in device memory.
// The pad rows are the identity in T, zero between them and the real rows,
// with right-hand sides of 1: no real row sees them, and every block is
// whole, so the unrolled loops carry no bounds test (one on every update
// put predicate juggling around every FMA). The substitution is
// blocked over 32-row diagonal blocks (from the top for L X = R, from the
// bottom for L^T X = R), two block barriers a block:
//   1. the block's rows of X are solved against its 32 x 32 triangle, one
//      thread a right-hand column holding the column's 32 entries in
//      registers, the factor read as shared-memory broadcasts;
//   2. all 256 threads update the real rows still open,
//      X_open -= T_blk^T X_blk, as a register-tiled float32 FMA product:
//      threads span the columns (the power of two at or above m, at most
//      32) and the rest of the block spans the rows, each thread owning 4
//      rows by 1, 2 or 4 columns (a template argument chosen from m). At
//      m = 1, the vector solves of the Laplace and GPC fleets, every thread
//      takes a row.
// No integer division indexes anything, and none of the TPU kernel's
// layout workarounds (RHS broadcast across lanes, 8-row panels, the 128
// padding) is carried over.
//
// Several matrices in one block (for small m and large B) were not
// chosen: the paths give the kernel B = 16 and the blocked solves' 128-
// column chunks, so the grid is small for any layout, and at m = 1 step 2
// already spreads the rows over every thread.
//
// Numerics: exact __fdiv_rn (no fast-math); plain float32 FMAs; nothing
// runs in TF32, so the tensor cores are out of reach and the levers are
// latency ones: few barriers, operands on chip, every thread at work. A
// zero dividend is kept off __fdiv_rn's slow path (five times the fast one
// on the H100).
//
// Bound on the card: n^2 m FMAs on 4 (n^2 / 2 + 2 n m) bytes per solve:
// at the paths' shapes (B = 16, n = m = 40, or m = 1) under a microsecond
// of either roof. What bounds it is each column's chain of divides and
// FMAs through the diagonal blocks (3,700-4,300 cycles a block), the
// loads (cp.async of 4-byte words), the barriers between blocks, and that
// only B of the 132 SMs have work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 32;  // rows of a diagonal block: one column's registers
constexpr int kRows = 4;  // rows of a thread's update tile

// a / b rounded to nearest. A zero dividend would take __fdiv_rn's slow
// path; it is divided as 1 and the zero given the quotient's sign instead.
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.f && (b < 0.f || b > 0.f);
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? a * q : q;
}

// n rounded up to whole diagonal blocks
__host__ __device__ __forceinline__ int padded(int n) { return (n + kBlk - 1) & ~(kBlk - 1); }

// Step 2: rows row0 .. row0 + mb - 1 of X (ld ldx) lose the block's 32
// rows from b0, with coefficients T[b0 + p][row] (ld ldl). Threads are a
// (kThreads >> lg) x (1 << lg) grid over rows and columns; each owns
// rows ty + TY * (a0 + a) and columns tx + 32 b.
template <int kCols>
__device__ __forceinline__ void update_open_rows(const float* sl, float* sx, int ldl, int ldx,
                                                 int m, int lg, int b0, int row0, int mb) {
  const int TY = kThreads >> lg;
  const int tx = threadIdx.x & ((1 << lg) - 1);
  const int ty = threadIdx.x >> lg;
  for (int r0 = ty; r0 < mb; r0 += kRows * TY) {
    float acc[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = r0 + a * TY;
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = tx + 32 * b;
        acc[a][b] = (r < mb && c < m) ? sx[(row0 + r) * ldx + c] : 0.f;
      }
    }
#pragma unroll 4
    for (int p = 0; p < kBlk; ++p) {
      const float* coef = sl + (b0 + p) * ldl + row0;
      const float* xrow = sx + (b0 + p) * ldx;
      float t[kRows], x[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int r = r0 + a * TY;
        t[a] = r < mb ? coef[r] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = tx + 32 * b;
        x[b] = c < m ? xrow[c] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int b = 0; b < kCols; ++b) acc[a][b] = fmaf(-t[a], x[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = r0 + a * TY;
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = tx + 32 * b;
        if (r < mb && c < m) sx[(row0 + r) * ldx + c] = acc[a][b];
      }
    }
  }
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
trisolve128_kernel(const float* __restrict__ Lm, const float* __restrict__ R,
                   float* __restrict__ X, int n, int m) {
  extern __shared__ float smem[];
  const int np = padded(n);
  const int ldl = np | 1, ldx = m | 1;
  float* sl = smem;              // T: [np][ldl]
  float* sx = smem + np * ldl;   // X: [np][ldx]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* l = Lm + static_cast<size_t>(blockIdx.x) * n * n;
  const float* r = R + static_cast<size_t>(blockIdx.x) * n * m;
  float* x = X + static_cast<size_t>(blockIdx.x) * n * m;

  // rows n .. np - 1 pad the system to whole diagonal blocks: T is the
  // identity there and zero between pad and real rows, so no real row
  // sees them, and their right-hand sides are 1, so their divides stay on
  // the fast path
  for (int i = warp; i < np; i += kWarps) {
    if (i < n) {
      for (int j = lane; j <= i; j += 32) {
        __pipeline_memcpy_async(kTranspose ? sl + i * ldl + j : sl + j * ldl + i, l + i * n + j, 4);
      }
      for (int j = lane; j < m; j += 32) __pipeline_memcpy_async(sx + i * ldx + j, r + i * m + j, 4);
      for (int j = n + lane; j < np; j += 32) sl[i * ldl + j] = 0.f;
    } else {
      for (int j = lane; j < m; j += 32) sx[i * ldx + j] = 1.f;
      for (int j = lane; j < np; j += 32) sl[i * ldl + j] = i == j ? 1.f : 0.f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int lg = 0;  // threads across the columns in step 2: 1 << lg >= m, at most 32
  while (lg < 5 && (1 << lg) < m) ++lg;
  const int kc = lg < 5 ? 1 : (m + 31) >> 5;
  const int nblk = np / kBlk;

  for (int q = 0; q < nblk; ++q) {
    const int b0 = (kTranspose ? nblk - 1 - q : q) * kBlk;

    // 1. the diagonal block: thread c solves column c
    if (tid < m) {
      float* col = sx + b0 * ldx + tid;
      const float* tb = sl + b0 * ldl + b0;
      float v[kBlk];
#pragma unroll
      for (int t = 0; t < kBlk; ++t) v[t] = col[t * ldx];
      if (!kTranspose) {
#pragma unroll
        for (int t = 0; t < kBlk; ++t) {
          v[t] = div_rn(v[t], tb[t * ldl + t]);
#pragma unroll
          for (int u = t + 1; u < kBlk; ++u) v[u] = fmaf(-tb[t * ldl + u], v[t], v[u]);
        }
      } else {
#pragma unroll
        for (int t = kBlk - 1; t >= 0; --t) {
          v[t] = div_rn(v[t], tb[t * ldl + t]);
#pragma unroll
          for (int u = 0; u < t; ++u) v[u] = fmaf(-tb[t * ldl + u], v[t], v[u]);
        }
      }
#pragma unroll
      for (int t = 0; t < kBlk; ++t) col[t * ldx] = v[t];
    }
    __syncthreads();

    // 2. the real rows still open: below the block, or above it for L^T
    const int row0 = kTranspose ? 0 : b0 + kBlk;
    const int mb = kTranspose ? b0 : n - row0;
    if (mb > 0) {
      switch (kc) {
        case 1: update_open_rows<1>(sl, sx, ldl, ldx, m, lg, b0, row0, mb); break;
        case 2: update_open_rows<2>(sl, sx, ldl, ldx, m, lg, b0, row0, mb); break;
        default: update_open_rows<4>(sl, sx, ldl, ldx, m, lg, b0, row0, mb); break;
      }
      __syncthreads();
    }
  }

  for (int i = warp; i < n; i += kWarps) {
    for (int j = lane; j < m; j += 32) x[i * m + j] = sx[i * ldx + j];
  }
}

template <bool kTranspose>
cudaError_t launch(const float* L, const float* R, float* X, int batch, int n, int m,
                   cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float)) * padded(n) * ((padded(n) | 1) + (m | 1));
  const cudaError_t err = cudaFuncSetAttribute(
      trisolve128_kernel<kTranspose>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  trisolve128_kernel<kTranspose><<<batch, kThreads, bytes, stream>>>(L, R, X, n, m);
  return cudaGetLastError();
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(transpose ? launch<true>(L, R, X, batch, n, m, st)
                                    : launch<false>(L, R, X, batch, n, m, st));
}
