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
// Design: the grid runs over tiles of `cols` columns of B (16, 32 or 64,
// chosen by the caller from m so that the grid covers the SMs: see
// ops/cuda_wide.py::tile_cols), 256 threads a block. Each block copies
// with cp.async, all loads in flight at once, the triangle it reads into
// shared memory as a row-major [128][132] square (16-byte chunks, and the
// chunk that holds the diagonal word by word; the unread triangle is
// never loaded, so NaN there cannot reach X), and its [128][cols] tile of
// B beside it. The substitution is blocked over 32-row diagonal blocks
// (from the top for L, from the bottom for U), two block barriers a block:
//   1. the block's 32 rows of the tile are solved against its 32 x 32
//      triangle, one thread a column holding the column's 32 entries in
//      registers, the factor read as shared-memory broadcasts (the scheme
//      of trisolve128.cu, one factor shared by the whole grid);
//   2. all 256 threads update the rows still open (below the block for L,
//      above it for U), X_open -= T_open,blk X_blk, as a register-tiled
//      float32 FMA product: a thread owns four neighbouring columns and up
//      to six rows, reads T four columns to a 16-byte load (the row stride
//      132 keeps eight rows' loads on distinct banks) and X four columns to
//      a 16-byte broadcast. The number of row tiles is a template argument
//      chosen from the open rows; surplus row tiles read a valid row of the
//      read triangle and are not stored, so no FMA sits behind a predicate.
// X goes back with 16-byte stores, neighbouring threads on neighbouring
// addresses. No loop runs 128 long: the longest unrolled one is a diagonal
// block's 32 steps, so the source builds in seconds. None of the TPU
// kernel's layout workarounds (8-row sublane panels, masked-reduce pivot
// extraction, the MXU update per panel) is carried over.
//
// Numerics: exact __fdiv_rn (the build uses no fast-math), a zero dividend
// kept off its slow path (div_rn); the updates are plain float32 FMAs in
// the plain version's order of blocks; nothing runs in TF32.
//
// Bound on the card: the work is m * 128^2 operations over about
// 4 * (2 * 128 * m + 8,256) bytes, some 30 operations a byte, under the
// card's float32 ridge; at m = 3968 the bound is about a microsecond. What
// holds a block back is the chain of 128 divides and FMAs through the four
// diagonal blocks, the load of the triangle (33 KB a block, from L2 after
// the first block) and the barriers between the blocks; narrow tiles put
// more SMs on the same chain, so the time barely grows with m.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 128;
constexpr int kMaxM = 8192;
constexpr int kThreads = 256;
constexpr int kBlk = 32;      // rows of a diagonal block: one column's registers
constexpr int kLd = kN + 4;   // T's row stride in shared memory
constexpr int kMaxRowTiles = 6;

// a / b rounded to nearest. A zero dividend would take __fdiv_rn's slow
// path; it is divided as 1 and the zero given the quotient's sign instead.
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.f && (b < 0.f || b > 0.f);
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? a * q : q;
}

// Step 2: the open rows row0 .. row0 + mb - 1 of the tile lose the
// diagonal block's rows b0 .. b0 + 31. Threads form a TY x (kCols / 4)
// grid; thread (ty, tx) owns columns 4 tx .. 4 tx + 3 and rows ty + TY a,
// a < kTiles. A row past the open ones is computed on row `spare` (a row
// whose entries in the block's columns lie in the read triangle) and not
// stored.
template <int kCols, int kTiles>
__device__ __forceinline__ void update_open_rows(const float* st, float* sx, int b0, int row0,
                                                 int mb, int spare) {
  constexpr int kQuads = kCols / 4;
  constexpr int TY = kThreads / kQuads;
  const int tx = threadIdx.x % kQuads;
  const int ty = threadIdx.x / kQuads;
  const float* trow[kTiles];
  float4 acc[kTiles];
#pragma unroll
  for (int a = 0; a < kTiles; ++a) {
    const int r = ty + TY * a;
    const int row = r < mb ? row0 + r : spare;
    trow[a] = st + row * kLd + b0;
    acc[a] = *reinterpret_cast<const float4*>(sx + row * kCols + 4 * tx);
  }
  const float* xblk = sx + b0 * kCols + 4 * tx;
#pragma unroll 2
  for (int p = 0; p < kBlk; p += 4) {
    float4 t[kTiles], x[4];
#pragma unroll
    for (int a = 0; a < kTiles; ++a) t[a] = *reinterpret_cast<const float4*>(trow[a] + p);
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = *reinterpret_cast<const float4*>(xblk + (p + q) * kCols);
#pragma unroll
    for (int a = 0; a < kTiles; ++a) {
      const float tv[4] = {t[a].x, t[a].y, t[a].z, t[a].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[a].x = fmaf(-tv[q], x[q].x, acc[a].x);
        acc[a].y = fmaf(-tv[q], x[q].y, acc[a].y);
        acc[a].z = fmaf(-tv[q], x[q].z, acc[a].z);
        acc[a].w = fmaf(-tv[q], x[q].w, acc[a].w);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kTiles; ++a) {
    const int r = ty + TY * a;
    if (r < mb) *reinterpret_cast<float4*>(sx + (row0 + r) * kCols + 4 * tx) = acc[a];
  }
}

template <bool kUpper, int kCols>
__global__ void __launch_bounds__(kThreads, 2)
widesolve128_kernel(const float* __restrict__ T, const float* __restrict__ B,
                    float* __restrict__ X, int m) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // T: [128][kLd], read triangle only
  float* sx = st + kN * kLd;                    // the tile: [128][kCols]
  constexpr int kQuads = kCols / 4;
  constexpr int TY = kThreads / kQuads;

  const int tid = threadIdx.x;
  const size_t c0 = static_cast<size_t>(blockIdx.x) * kCols;

  // the read triangle, 16 bytes a chunk (a warp takes a row's 32 chunks);
  // the chunk holding the diagonal goes word by word
  for (int idx = tid; idx < kN * (kN / 4); idx += kThreads) {
    const int i = idx >> 5;
    const int j0 = (idx & 31) * 4;
    const float* src = T + i * kN + j0;
    float* dst = st + i * kLd + j0;
    const bool whole = kUpper ? j0 >= i : j0 + 3 <= i;
    const bool part = kUpper ? (j0 < i && i <= j0 + 3) : (j0 <= i && i < j0 + 3);
    if (whole) {
      __pipeline_memcpy_async(dst, src, 16);
    } else if (part) {
      for (int j = 0; j < 4; ++j) {
        if (kUpper ? j0 + j >= i : j0 + j <= i) __pipeline_memcpy_async(dst + j, src + j, 4);
      }
    }
  }
  for (int idx = tid; idx < kN * kQuads; idx += kThreads) {
    const int i = idx / kQuads;
    const int q = idx - i * kQuads;
    __pipeline_memcpy_async(sx + i * kCols + 4 * q, B + i * static_cast<size_t>(m) + c0 + 4 * q,
                            16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int q = 0; q < kN / kBlk; ++q) {
    const int b0 = (kUpper ? kN / kBlk - 1 - q : q) * kBlk;

    // 1. the diagonal block: thread c solves column c
    if (tid < kCols) {
      float* col = sx + b0 * kCols + tid;
      const float* tb = st + b0 * kLd + b0;
      float v[kBlk];
#pragma unroll
      for (int t = 0; t < kBlk; ++t) v[t] = col[t * kCols];
      if (!kUpper) {
#pragma unroll
        for (int t = 0; t < kBlk; ++t) {
          v[t] = div_rn(v[t], tb[t * kLd + t]);
#pragma unroll
          for (int u = t + 1; u < kBlk; ++u) v[u] = fmaf(-tb[u * kLd + t], v[t], v[u]);
        }
      } else {
#pragma unroll
        for (int t = kBlk - 1; t >= 0; --t) {
          v[t] = div_rn(v[t], tb[t * kLd + t]);
#pragma unroll
          for (int u = 0; u < t; ++u) v[u] = fmaf(-tb[u * kLd + t], v[t], v[u]);
        }
      }
#pragma unroll
      for (int t = 0; t < kBlk; ++t) col[t * kCols] = v[t];
    }
    __syncthreads();

    // 2. the rows still open: below the block for L, above it for U
    const int row0 = kUpper ? 0 : b0 + kBlk;
    const int mb = kUpper ? b0 : kN - row0;
    if (mb > 0) {
      // a row whose entries in the block's columns lie in the read triangle
      const int spare = kUpper ? 0 : kN - 1;
      switch ((mb + TY - 1) / TY) {
        case 1: update_open_rows<kCols, 1>(st, sx, b0, row0, mb, spare); break;
        case 2: update_open_rows<kCols, 2>(st, sx, b0, row0, mb, spare); break;
        case 3: update_open_rows<kCols, 3>(st, sx, b0, row0, mb, spare); break;
        case 4: update_open_rows<kCols, 4>(st, sx, b0, row0, mb, spare); break;
        case 5: update_open_rows<kCols, 5>(st, sx, b0, row0, mb, spare); break;
        default: update_open_rows<kCols, kMaxRowTiles>(st, sx, b0, row0, mb, spare); break;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < kN * kQuads; idx += kThreads) {
    const int i = idx / kQuads;
    const int q = idx - i * kQuads;
    *reinterpret_cast<float4*>(X + i * static_cast<size_t>(m) + c0 + 4 * q) =
        *reinterpret_cast<const float4*>(sx + i * kCols + 4 * q);
  }
}

template <bool kUpper, int kCols>
cudaError_t launch(const float* T, const float* B, float* X, int m, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(float)) * kN * (kLd + kCols);
  // the dynamic shared memory limit, raised once a process for each
  // instantiation (every one needs more than the 48 KB default)
  static const cudaError_t set = cudaFuncSetAttribute(
      widesolve128_kernel<kUpper, kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  widesolve128_kernel<kUpper, kCols><<<m / kCols, kThreads, bytes, stream>>>(T, B, X, m);
  return cudaGetLastError();
}

template <bool kUpper>
cudaError_t launch_cols(const float* T, const float* B, float* X, int m, int cols,
                        cudaStream_t stream) {
  switch (cols) {
    case 16: return launch<kUpper, 16>(T, B, X, m, stream);
    case 32: return launch<kUpper, 32>(T, B, X, m, stream);
    default: return launch<kUpper, 64>(T, B, X, m, stream);
  }
}

}  // namespace

// T: [128, 128]; B and X: [128, m]; float32, contiguous and 16-byte
// aligned, on the current device; X must not overlap T or B. m is a
// positive multiple of 128, at most 8192; cols (16, 32 or 64) is the
// columns a block takes. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int widesolve128_launch(const float* T, const float* B, float* X, int m, int upper,
                                   int cols, void* stream) {
  if (m <= 0 || m % kN != 0 || m > kMaxM || (cols != 16 && cols != 32 && cols != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(upper ? launch_cols<true>(T, B, X, m, cols, st)
                                : launch_cols<false>(T, B, X, m, cols, st));
}
