// The blocked right-looking Cholesky of chol128.cu (K1, K4, K5) as device
// functions, shared with newton128.cu (K3), which factors its Newton system
// with it. Included after <cuda_runtime.h>; a block is 256 threads.
//
// The matrix lies in shared memory, row i at s[i * ld] (ld odd: the 32
// lanes of a warp that walk a column hit 32 banks), its lower triangle
// read, padded from n real rows to np rows with the identity. The
// factorization runs over panels of 32 columns, three block barriers a
// panel (see factor for K3's variant):
//   1. one warp factors the panel's diagonal block, each lane holding one
//      of its rows in registers: the pivot is broadcast by __shfl_sync,
//      every lane takes its square root, scales its own entry and applies
//      the rank-1 update to its row, with no block barrier. Lane j + 1
//      forms the next pivot from its own entries, so the chain from pivot
//      to pivot is a shuffle, a square root, a divide and an FMA. The
//      padding makes every panel whole, so the step is straight-line code:
//      with no branch around the shuffles the compiler needs no
//      reconvergence code at each one. The last panel may be 4 to 28 wide
//      (a template argument; K1 pads to 32, K3 to 4);
//   2. the rows below the panel, one thread a row (up to 96), solve
//      against the diagonal block (L21 = A21 L11^-T), the row in registers
//      and L11 read as shared-memory broadcasts; each thread also copies
//      its finished row to the panel buffer pb with a 16-byte row stride;
//   3. all 256 threads apply the panel to the trailing lower triangle,
//      A22 -= L21 L21^T, as a register-tiled float32 FMA product: thread
//      (ty, tx) of a 16 x 16 grid owns rows ty + 16a and columns tx + 16b,
//      b <= a (the pairs that can lie on or below the diagonal), so no
//      index is divided and no tile above the diagonal is computed. Its
//      operands come from the panel buffer four columns to a 16-byte load
//      (a stride of 36 floats keeps eight rows' loads on distinct banks).
//      The tile's span (1 to kMaxSpan rows and columns) is a template
//      argument chosen from the trailing size, so no FMA runs on padding.
// Steps 2 and 3 take the real rows only. Every entry receives its updates
// in the plain version's order (panel by panel, column by column).
//
// Numerics: exact __fsqrt_rn and __fdiv_rn, a zero dividend kept off
// __fdiv_rn's slow path (five times the fast one on the H100); plain
// float32 FMAs, nothing in TF32.

#pragma once

namespace panel_chol {

constexpr int kThreads = 256;
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

// Floats of the panel buffer for n real rows.
__host__ __device__ __forceinline__ int panel_floats(int n) {
  return n > kPanel ? (n - kPanel) * kPld : 0;
}

// Step 1 on the kW x kW diagonal block at k0, in one warp (lane = row
// k0 + lane; lanes past kW hold nothing). A failed pivot (not positive, or
// NaN) is recorded and the steps after it run on a pivot of 1. Returns
// whether every pivot was positive (the same in every lane).
template <int kW>
__device__ __forceinline__ bool diag_block(float* s, int ld, int k0, int lane) {
  float* row = s + (k0 + lane) * ld + k0;
  float r[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c) r[c] = (c <= lane && (kW == kPanel || lane < kW)) ? row[c] : 0.f;
  bool ok = true;
  float d = __shfl_sync(kAll, r[0], 0);
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    ok = ok && d > 0.f;  // not positive, or NaN, fails
    const float piv = __fsqrt_rn(ok ? d : 1.f);
    // column j: the pivot in lane j, L[l][j] below it, 0 above (a lane's
    // entries above the diagonal hold partial sums that are never stored,
    // and are zeroed here before they could be divided)
    const float q = div_rn(lane > j ? r[j] : 0.f, piv);
    r[j] = lane == j ? piv : q;
    if (j + 1 < kW) {
      // lane j + 1's own update of its diagonal entry: the next pivot
      d = __shfl_sync(kAll, fmaf(-r[j], r[j], r[j + 1]), j + 1);
    }
#pragma unroll
    for (int c = j + 1; c < kW; ++c) {
      r[c] = fmaf(-r[j], __shfl_sync(kAll, r[j], c), r[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    if (c <= lane && (kW == kPanel || lane < kW)) row[c] = r[c];
  }
  return ok;
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

// Factors the n real rows of the np-row matrix at s (np - n identity rows
// below them) in place; n - 32 <= 16 kMaxSpan. pb holds panel_floats(n)
// floats, 16-byte aligned. *failed is a shared word the caller has set to
// 0 before a block barrier; the function ends on a block barrier and
// returns whether a pivot failed, the same in every thread. Three block
// barriers a panel.
// np is a multiple of 32 (K1), or with kNarrow (K3) of 4, the last panel
// then 4 to 32 wide.
template <int kMaxSpan, bool kNarrow>
__device__ __forceinline__ bool factor(float* s, int ld, float* pb, int n, int np,
                                       int* failed) {
  static_assert(kMaxSpan >= 6 && kMaxSpan <= 7, "trailing spans 1-5 are instantiated below");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int k1 = k0 + kPanel;  // the first row below the panel

    // 1. the diagonal block, one warp
    if (warp == 0) {
      bool ok;
      if constexpr (kNarrow) {
        switch (np - k0) {
          case 4: ok = diag_block<4>(s, ld, k0, lane); break;
          case 8: ok = diag_block<8>(s, ld, k0, lane); break;
          case 12: ok = diag_block<12>(s, ld, k0, lane); break;
          case 16: ok = diag_block<16>(s, ld, k0, lane); break;
          case 20: ok = diag_block<20>(s, ld, k0, lane); break;
          case 24: ok = diag_block<24>(s, ld, k0, lane); break;
          case 28: ok = diag_block<28>(s, ld, k0, lane); break;
          default: ok = diag_block<kPanel>(s, ld, k0, lane); break;
        }
      } else {
        ok = diag_block<kPanel>(s, ld, k0, lane);
      }
      if (!ok && lane == 0) *failed = 1;
    }
    __syncthreads();
    if (*failed) return true;  // uniform: every thread reads it after the barrier
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
      case 6:
        if constexpr (kMaxSpan > 6) {
          trailing_update<6>(s, ld, pb, k1, m);
          break;
        }
        [[fallthrough]];
      default: trailing_update<kMaxSpan>(s, ld, pb, k1, m); break;
    }
    __syncthreads();
  }
  return false;
}

}  // namespace panel_chol
