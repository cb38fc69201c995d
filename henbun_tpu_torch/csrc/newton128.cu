// Batched damped saddle-free Newton mode of the Laplace approximation on
// Hopper: the whole Newton loop of a batch of models in one launch.
//
// Replaces the TPU kernel henbun_tpu/ops/pallas_newton.py::newton_mode_vbatched
// (kernel body _newton_kernel). For each model b it maximizes
//
//     psi(v) = sum_i ll(y_i, f_i) - |v|^2 / 2,   f = Lk v,  Lk [n, m],
//
// from v = 0 by `iters` iterations of inference/laplace.py::_newton_iterations:
//   1. f = Lk v;
//   2. ll, g = d ll/df and |W| = |d2 ll/df2| in closed form (tag 0:
//      bernoulli_logit; tag 1: student_t with scale var and fixed df, the
//      parameterization of densities.student_t: s^2 = var^2);
//   3. psi0 by block reduction;
//   4. B = Lk^T |W| Lk, its diagonal shifted as _newton_iterations shifts
//      it: b_kk = ((1 + B_kk) + floor) + jitter, floor = jitter (1 + max_k
//      (1 + B_kk)) over the real m x m system, i.e. 1 + jitter (2 + max
//      diag) + jitter in all (the Pallas kernel adds one jitter less);
//   5. the Cholesky factor of B;
//   6. a forward and a back substitution for d = B^-1 (Lk^T g - v);
//   7. psi at the four trial points v + alpha d, alpha in (1, .3, .1, .03);
//   8. the ladder: the full step on psi_1 >= psi0 - 1e-5 (1 + |psi0|), each
//      smaller step only on a strict improvement of the best so far.
// A NaN psi fails every comparison and a factor with a pivot that is not
// positive (or NaN) skips the step, so that model keeps its v; every model
// is its own block, so nothing of one model reaches another.
//
// Design: one thread block of 256 threads per model (grid = B, any B),
// the whole loop in one launch, everything in dynamic shared memory: Lk
// transposed (LkT [m][ldt], columns padded with zeros to a multiple of 32
// plus 4, so four data points are one 16-byte load and eight rows' loads
// fall on distinct banks), the system, the panel buffer and the vectors.
// Lk, y and var are read from device memory once (cp.async), v* written
// once. An iteration:
//   * f = Lk v and the four trial points' Lk (v + alpha d), the four in
//     one pass: 2, 4 or 8 threads a data point split the dot products and
//     join them with shuffles;
//   * Lk^T g and B = Lk^T (|W| Lk): B's lower triangle as a register-tiled
//     product over the 16 x 16 thread grid (thread (ty, tx) owns rows
//     ty + 16a and columns tx + 16b, b <= a, the span a template argument
//     chosen from m): two 16-byte loads feed four FMAs per owned pair, and
//     no index is decoded;
//   * one block reduction joins sum ll, |v|^2 and the largest diagonal,
//     another the four trial points' psi;
//   * the factor is panel_chol.cuh's blocked Cholesky (K1's: 32-column
//     panels, one warp a diagonal block in registers with shuffles, the
//     rows below a thread a row, a register-tiled trailing update, three
//     barriers a panel) on the system bordered by one more row, Lk^T g - v:
//     factoring [[B, .], [r^T, big]] leaves L^-1 r in that row, so the
//     forward substitution is the factor's own row solve and update. The
//     bordered system is padded with the identity to a multiple of 4 rows
//     (the last panel 4-32 wide); padding enters neither the floor, nor
//     psi, nor v, and the border's pivot (3e38 - |L^-1 r|^2) fails only
//     when L^-1 r is not finite, when the step could not be taken anyway;
//   * the back substitution L^T d = L^-1 r runs in one warp over 32-row
//     blocks from the bottom: lane t holds row t and column t of the
//     diagonal block, the solved entry goes to every lane by a shuffle;
//     then the lanes take the block's entries out of the rows above. No
//     block barrier is needed between the blocks.
// Loops that hold no register array stay rolled (the back substitution,
// the trial points' products and likelihoods): an iteration's code must
// fit the SM's instruction cache, or every iteration fetches its
// straight-line factor code afresh (measured: the first panel's diagonal
// block 13,000 cycles with unrolled copies, 8,800 without, K1's 8,200).
// The dynamic shared memory limit is raised once a process, for the
// largest system (156,384 bytes at n = m = 128). No TPU layout workaround
// is kept: no padding to 128, no 8-row panels, no masked-reduce pivot
// extraction, no upper factor to transpose, no right-hand side broadcast
// across lanes.
//
// Numerics: exact __fsqrt_rn / __fdiv_rn (a zero dividend kept off the
// divide's slow path), expf / logf / log1pf without fast math, a stable
// softplus for the Bernoulli terms, the Student-t constant from the host
// (math.lgamma in double); plain float32 arithmetic, nothing in TF32. The
// trial points are formed as the plain version forms them (alpha d, then
// + v, each rounded).
//
// Bound on the card: at the training path's shapes (B = 16, n = m = 40) the
// work is about 0.7 MFLOP a model an iteration and the bytes about 0.1 MB
// in all, so neither bounds it: the dependent chains do (the factor's
// pivot chain, about a quarter of a microsecond a pivot, and the back
// substitution's divide-and-shuffle chain), with the barriers between the
// phases, and only B of the 132 SMs have work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "panel_chol.cuh"

namespace {

using panel_chol::div_rn;
using panel_chol::kAll;
using panel_chol::kGrid;
using panel_chol::kThreads;
constexpr int kMaxN = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTrials = 4;
constexpr float kBorder = 3e38f;  // the bordered system's last diagonal entry

__device__ __forceinline__ float step_size(int a) {
  return a == 0 ? 1.0f : (a == 1 ? 0.3f : (a == 2 ? 0.1f : 0.03f));
}

// max that propagates NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

struct Lik {
  int tag;
  float df;
  float s2;     // student_t: scale^2
  float dfs2;   // df * s2
  float konst;  // student_t: host constant - log(s2) / 2
};

__device__ __forceinline__ float loglik(const Lik& L, float y, float f) {
  if (L.tag == 0) return -y * softplus(-f) - (1.f - y) * softplus(f);
  const float r = y - f;
  const float denom = L.dfs2 + r * r;
  return L.konst - 0.5f * (L.df + 1.f) * logf(div_rn(denom, L.dfs2));
}

// ll, g and |W| at one data point
__device__ __forceinline__ float lik_terms(const Lik& L, float y, float f, float* g,
                                           float* w) {
  if (L.tag == 0) {
    const float sig = div_rn(1.f, 1.f + expf(-f));
    *g = y - sig;
    *w = sig * (1.f - sig);
    return loglik(L, y, f);
  }
  const float r = y - f;
  const float denom = L.dfs2 + r * r;
  *g = div_rn((L.df + 1.f) * r, denom);
  *w = fabsf(div_rn((L.df + 1.f) * (L.dfs2 - r * r), denom * denom));
  return loglik(L, y, f);
}

// Joins K values over the block, the first K - kMax by sum and the last
// kMax by NaN-propagating max, in a fixed order, so every thread gets the
// same results. One block barrier; `scratch` (kWarps * K floats) must not
// be written again before every thread has passed a later barrier.
template <int K, int kMax>
__device__ __forceinline__ void block_reduce(float (&x)[K], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o = __shfl_xor_sync(kAll, x[k], off);
      x[k] = k < K - kMax ? x[k] + o : nan_max(x[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = x[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = scratch[k];
    for (int q = 1; q < kWarps; ++q) {
      s = k < K - kMax ? s + scratch[q * K + k] : nan_max(s, scratch[q * K + k]);
    }
    x[k] = s;
  }
}

// (Lk x_a)_i for K vectors x_a (rows of x, stride ldx), i = gi clamped to
// a real row: the dot products over m split between the G = 1 << lg
// threads of a group (thread gp takes k = gp, gp + G, ...) and joined by
// shuffles, so every thread of the group gets all K.
template <int K>
__device__ __forceinline__ void lk_times(const float* lkt, int ldt, const float* x, int ldx,
                                         int i, int gp, int lg, int m, float (&f)[K]) {
#pragma unroll
  for (int a = 0; a < K; ++a) f[a] = 0.f;
  for (int k = gp; k < m; k += 1 << lg) {
    const float l = lkt[k * ldt + i];
#pragma unroll
    for (int a = 0; a < K; ++a) f[a] = fmaf(l, x[a * ldx + k], f[a]);
  }
  for (int off = 1; off < 1 << lg; off <<= 1) {
#pragma unroll
    for (int a = 0; a < K; ++a) f[a] += __shfl_xor_sync(kAll, f[a], off);
  }
}

// B = Lk^T (|W| Lk), lower triangle, into s (row stride lds): thread
// (ty, tx) owns rows ty + 16a and columns tx + 16b, b <= a < kSpan; a row
// or column past m is computed on row m - 1 and not stored. The data
// points run four at a time (n4 = n rounded up to 4; LkT and |W| are zero
// past n). Returns the NaN-propagating max of 1 + B_kk over the diagonal
// entries the thread owns (-inf if none).
template <int kSpan>
__device__ __forceinline__ float form_system(const float* lkt, int ldt, const float* w, float* s,
                                             int lds, int n4, int m) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & (kGrid - 1);
  const float* rowp[kSpan];
  const float* colp[kSpan];
#pragma unroll
  for (int a = 0; a < kSpan; ++a) {
    rowp[a] = lkt + min(ty + kGrid * a, m - 1) * ldt;
    colp[a] = lkt + min(tx + kGrid * a, m - 1) * ldt;
  }
  float acc[kSpan][kSpan];
#pragma unroll
  for (int a = 0; a < kSpan; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) acc[a][b] = 0.f;
  }
#pragma unroll 2
  for (int i = 0; i < n4; i += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + i);
    float4 lr[kSpan], lc[kSpan];
#pragma unroll
    for (int a = 0; a < kSpan; ++a) {
      lr[a] = *reinterpret_cast<const float4*>(rowp[a] + i);
      const float4 c = *reinterpret_cast<const float4*>(colp[a] + i);
      lc[a] = make_float4(w4.x * c.x, w4.y * c.y, w4.z * c.z, w4.w * c.w);
    }
#pragma unroll
    for (int a = 0; a < kSpan; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        acc[a][b] = fmaf(lr[a].x, lc[b].x, acc[a][b]);
        acc[a][b] = fmaf(lr[a].y, lc[b].y, acc[a][b]);
        acc[a][b] = fmaf(lr[a].z, lc[b].z, acc[a][b]);
        acc[a][b] = fmaf(lr[a].w, lc[b].w, acc[a][b]);
      }
    }
  }
  float dmax = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
  for (int a = 0; a < kSpan; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int r = ty + kGrid * a, c = tx + kGrid * b;
      if (r < m && c <= r) {
        s[r * lds + c] = acc[a][b];
        if (c == r) dmax = nan_max(dmax, 1.f + acc[a][b]);
      }
    }
  }
  return dmax;
}

// One warp solves L^T d = r on the diagonal block of rows b0 .. b0 + w - 1
// (w <= 32, b0 + w <= m; lanes from w on idle): lane t holds r_t (the border
// row, already reduced by the blocks below) and L_tt, and runs from the
// last row up; x_s, formed in lane s, goes to every lane by a shuffle,
// and lane t takes L[b0 + s][b0 + t] x_s off r_t. The loop stays rolled
// (small code). Writes d[b0 + t] for the real rows.
__device__ __forceinline__ void back_block(const float* s, int lds, const float* r, float* d,
                                           int b0, int w, int lane) {
  const int row = b0 + lane;
  const bool real = lane < w;
  float rt = real ? r[row] : 0.f;
  const float dg = real ? s[row * lds + row] : 1.f;
  float xo = 0.f;
#pragma unroll 1
  for (int t = w - 1; t >= 0; --t) {
    const float c = (real && t > lane) ? s[(b0 + t) * lds + row] : 0.f;
    const float x = __shfl_sync(kAll, div_rn(rt, dg), t);
    xo = lane == t ? x : xo;
    rt = fmaf(-c, x, rt);
  }
  if (real) d[row] = xo;
}

__host__ __device__ __forceinline__ int pad32(int n) { return (n + 31) & ~31; }
// LkT's row stride: four data points a 16-byte load, and a stride of 4
// mod 32 banks so that eight rows' loads fall on distinct banks
__host__ __device__ __forceinline__ int lkt_ld(int n) { return pad32(n) + 4; }
// rows of the bordered system (m + 1), padded to a multiple of 4
__host__ __device__ __forceinline__ int sys_rows(int m) { return (m + 1 + 3) & ~3; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory, in floats: LkT, the system, the panel buffer,
// then y, g, |W| (pad32(n) each) and v, d and the four trial points
// (pad32(m) each).
__host__ __device__ __forceinline__ int smem_floats(int n, int m) {
  return m * lkt_ld(n) + round4(sys_rows(m) * (sys_rows(m) | 1)) +
         panel_chol::panel_floats(m + 1) + 3 * pad32(n) + (2 + kTrials) * pad32(m);
}

__global__ void __launch_bounds__(kThreads, 1)
newton128_kernel(const float* __restrict__ Lk_g, const float* __restrict__ y_g,
                 const float* __restrict__ var_g, float* __restrict__ v_g, int n, int m,
                 int iters, int tag, float df, float host_const, float jitter) {
  extern __shared__ float4 smem4[];
  __shared__ float s_red3[kWarps * 3];
  __shared__ float s_red8[kWarps * 2 * kTrials];
  __shared__ int s_failed;

  const int ldt = lkt_ld(n);
  const int np = sys_rows(m);
  const int lds = np | 1;
  float* lkt = reinterpret_cast<float*>(smem4);  // [m][ldt]
  float* S = lkt + m * ldt;                      // [np][lds], lower triangle
  float* pb = S + round4(np * lds);              // the factor's panel buffer
  float* y = pb + panel_chol::panel_floats(m + 1);
  float* g = y + pad32(n);
  float* w = g + pad32(n);
  float* v = w + pad32(n);
  float* d = v + pad32(m);
  float* vt = d + pad32(m);  // [kTrials][pad32(m)]
  float* border = S + m * lds;  // row m: Lk^T g - v, then L^-1 of it

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const float* lk = Lk_g + static_cast<size_t>(b) * n * m;
  for (int idx = tid; idx < n * m; idx += kThreads) {
    const int i = idx / m;
    __pipeline_memcpy_async(lkt + (idx - i * m) * ldt + i, lk + idx, 4);
  }
  for (int i = tid; i < n; i += kThreads) {
    __pipeline_memcpy_async(y + i, y_g + static_cast<size_t>(b) * n + i, 4);
  }
  __pipeline_commit();
  const int n32 = pad32(n);
  for (int idx = tid; idx < m * (n32 - n); idx += kThreads) {
    const int k = idx / (n32 - n);
    lkt[k * ldt + n + idx - k * (n32 - n)] = 0.f;
  }
  for (int i = n + tid; i < n32; i += kThreads) g[i] = w[i] = 0.f;
  for (int k = tid; k < m; k += kThreads) v[k] = 0.f;
  // the padding rows m + 1 .. np - 1 are the identity; no step writes them
  for (int i = m + 1 + warp; i < np; i += kWarps) {
    for (int j = lane; j <= i; j += 32) S[i * lds + j] = i == j ? 1.f : 0.f;
  }

  Lik L;
  L.tag = tag;
  L.df = df;
  const float scale = var_g[b];
  L.s2 = scale * scale;
  L.dfs2 = df * L.s2;
  L.konst = host_const - 0.5f * logf(L.s2);

  // f = Lk x: 2, 4 or 8 threads a data point
  const int lg = n <= 32 ? 3 : (n <= 64 ? 2 : 1);
  const int gi = tid >> lg, gp = tid & ((1 << lg) - 1);
  const int gic = min(gi, n - 1);
  const int span = (m + kGrid - 1) / kGrid;
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // 1-2. f = Lk v and the likelihood terms; the partial sums of psi0
    float acc3[3] = {0.f, 0.f, 0.f};  // sum ll, sum v^2, max (1 + B_kk)
    {
      float f[1];
      lk_times(lkt, ldt, v, 0, gic, gp, lg, m, f);
      if (gp == 0 && gi < n) acc3[0] = lik_terms(L, y[gi], f[0], &g[gi], &w[gi]);
      if (tid < m) acc3[1] = v[tid] * v[tid];
    }
    __syncthreads();

    // 4. the border Lk^T g - v and the system B = Lk^T (|W| Lk)
    if (tid < m) {
      const float* row = lkt + tid * ldt;
      float a = 0.f;
      for (int i = 0; i < n; i += 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(row + i);
        const float4 g4 = *reinterpret_cast<const float4*>(g + i);
        a = fmaf(l4.x, g4.x, a);
        a = fmaf(l4.y, g4.y, a);
        a = fmaf(l4.z, g4.z, a);
        a = fmaf(l4.w, g4.w, a);
      }
      border[tid] = a - v[tid];
    }
    const int n4 = (n + 3) & ~3;
    switch (span) {
      case 1: acc3[2] = form_system<1>(lkt, ldt, w, S, lds, n4, m); break;
      case 2: acc3[2] = form_system<2>(lkt, ldt, w, S, lds, n4, m); break;
      case 3: acc3[2] = form_system<3>(lkt, ldt, w, S, lds, n4, m); break;
      case 4: acc3[2] = form_system<4>(lkt, ldt, w, S, lds, n4, m); break;
      case 5: acc3[2] = form_system<5>(lkt, ldt, w, S, lds, n4, m); break;
      case 6: acc3[2] = form_system<6>(lkt, ldt, w, S, lds, n4, m); break;
      case 7: acc3[2] = form_system<7>(lkt, ldt, w, S, lds, n4, m); break;
      default: acc3[2] = form_system<8>(lkt, ldt, w, S, lds, n4, m); break;
    }
    block_reduce<3, 1>(acc3, s_red3);
    const float psi0 = acc3[0] - 0.5f * acc3[1];
    const float floor_ = jitter * (1.f + acc3[2]);
    if (tid < m) S[tid * lds + tid] = ((1.f + S[tid * lds + tid]) + floor_) + jitter;
    if (tid == 0) {
      S[m * lds + m] = kBorder;
      s_failed = 0;
    }
    __syncthreads();

    // 5. the factor of the bordered system, which leaves the forward
    // substitution's L^-1 (Lk^T g - v) in its last row; a failed pivot
    // keeps v (uniform: the flag is read after a barrier), as a NaN step
    // would
    if (panel_chol::factor<7, true>(S, lds, pb, m + 1, np, &s_failed)) continue;

    // 6. L^T d = L^-1 (Lk^T g - v) in warp 0 (no block barrier between its
    // steps): 32-row blocks from the bottom, each solved by back_block and
    // then taken out of the rows above
    if (warp == 0) {
      for (int b0 = (m - 1) & ~31; b0 >= 0; b0 -= 32) {
        const int rows = min(m - b0, 32);
        back_block(S, lds, border, d, b0, rows, lane);
        __syncwarp();
        for (int k = lane; k < b0; k += 32) {
          float a = border[k];
#pragma unroll 4
          for (int u = 0; u < rows; ++u) a = fmaf(-S[(b0 + u) * lds + k], d[b0 + u], a);
          border[k] = a;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 7. psi at the four trial points v + alpha d (alpha d, then + v, each
    // rounded, as the plain version forms them)
    float acc8[2 * kTrials];
#pragma unroll
    for (int a = 0; a < 2 * kTrials; ++a) acc8[a] = 0.f;
    if (tid < m) {
#pragma unroll
      for (int a = 0; a < kTrials; ++a) {
        const float x = __fadd_rn(v[tid], __fmul_rn(step_size(a), d[tid]));
        vt[a * pad32(m) + tid] = x;
        acc8[kTrials + a] = x * x;
      }
    }
    __syncthreads();
    {
      float f[kTrials];
      lk_times(lkt, ldt, vt, pad32(m), gic, gp, lg, m, f);
      if (gi < n) {
        // thread gp of the group takes the trial points gp, gp + G, ...
        // (one inlined loglik, to keep the hot code small)
        const float yi = y[gi];
#pragma unroll 1
        for (int a = gp; a < kTrials; a += 1 << lg) {
          const float fa = a == 0 ? f[0] : (a == 1 ? f[1] : (a == 2 ? f[2] : f[3]));
          const float l = loglik(L, yi, fa);
#pragma unroll
          for (int q = 0; q < kTrials; ++q) acc8[q] = q == a ? l : acc8[q];
        }
      }
    }
    block_reduce<2 * kTrials, 0>(acc8, s_red8);

    // 8. the ladder (every thread decides the same)
    const float tie_tol = 1e-5f * (1.f + fabsf(psi0));
    float best = psi0;
    int sel = -1;
#pragma unroll
    for (int a = 0; a < kTrials; ++a) {
      const float p = acc8[a] - 0.5f * acc8[kTrials + a];
      if (a == 0 ? (p >= best - tie_tol) : (p > best)) {
        best = p;
        sel = a;
      }
    }
    if (sel >= 0 && tid < m) v[tid] = vt[sel * pad32(m) + tid];
    __syncthreads();
  }

  for (int k = tid; k < m; k += kThreads) v_g[static_cast<size_t>(b) * m + k] = v[k];
}

}  // namespace

// Lk [batch, n, m], y [batch, n, 1], var [batch] (student_t scale), v
// [batch, m, 1]: float32, contiguous, on the current device. tag 0:
// bernoulli_logit, 1: student_t (df > 0, host_const its lgamma constant).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int newton128_launch(const float* Lk, const float* y, const float* var, float* v,
                                int batch, int n, int m, int iters, int tag, float df,
                                float host_const, float jitter, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || n > kMaxN || m > kMaxN || iters < 0 ||
      (tag != 0 && tag != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the limit is raised once a process, to the largest system's size
  static const cudaError_t set = cudaFuncSetAttribute(
      newton128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxN, kMaxN) * sizeof(float)));
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t bytes = smem_floats(n, m) * sizeof(float);
  newton128_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      Lk, y, var, v, n, m, iters, tag, df, host_const, jitter);
  return static_cast<int>(cudaGetLastError());
}
