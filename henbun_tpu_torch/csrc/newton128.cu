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
//      (1 + B_kk)), i.e. 1 + jitter (2 + max diag) + jitter in all (the
//      Pallas kernel adds one jitter less);
//   5. an in-place Cholesky of B (K1's right-looking column algorithm);
//   6. a forward and a back vector substitution for d = B^-1 (Lk^T g - v);
//   7. psi at the four trial points v + alpha d, alpha in (1, .3, .1, .03);
//   8. the ladder: the full step on psi_1 >= psi0 - 1e-5 (1 + |psi0|), each
//      smaller step only on a strict improvement of the best so far.
// A NaN psi fails every comparison and a factor with a pivot that is not
// positive (or NaN) skips the step, so that model keeps its v; every model
// is its own block, so nothing of one model reaches another.
//
// Design: one thread block per model (grid = B, any B), 256 threads. Lk
// [n, m] and the m x m system live in dynamic shared memory with an odd row
// stride (no bank conflicts on row-wise dot products), beside the vectors
// y, g, |W|, v, the gradient, the direction and the four trial points, so
// every iteration runs from shared memory; Lk, y and var are read from
// device memory once and v* written once. At n = m = 128 that is about
// 135 KiB, above the 48 KiB default: the launcher raises the block's
// dynamic shared memory limit first. The two substitutions run in warp 0
// alone (__syncwarp between steps); the factorization and the products use
// the whole block. No TPU layout workaround is kept: no padding to 128, no
// 8-row panels, no masked-reduce pivot extraction, no upper factor to
// transpose, no right-hand side broadcast across lanes.
//
// Numerics: exact __fsqrt_rn / __fdiv_rn, expf / logf / log1pf without fast
// math, a stable softplus for the Bernoulli terms, the Student-t constant
// from the host (math.lgamma in double); plain float32 arithmetic, nothing
// in TF32.
//
// Bound on the card: at the training path's shapes (B = 16, n = m = 40) the
// work is about 0.7 MFLOP a model an iteration and the bytes about 0.1 MB
// in all, so neither bounds it: the chain of ~2m barriers of each
// iteration's factorization, the warp-serial substitutions and the launch
// do, and only B of the 132 SMs have work. Making it fast (several models
// a block, a warp-level factorization, tensor-core products at n = 128) is
// left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTrials = 4;

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
  return L.konst - 0.5f * (L.df + 1.f) * logf(__fdiv_rn(denom, L.dfs2));
}

// ll, g and |W| at one data point
__device__ __forceinline__ float lik_terms(const Lik& L, float y, float f, float* g,
                                           float* w) {
  if (L.tag == 0) {
    const float sig = __fdiv_rn(1.f, 1.f + expf(-f));
    *g = y - sig;
    *w = sig * (1.f - sig);
    return loglik(L, y, f);
  }
  const float r = y - f;
  const float denom = L.dfs2 + r * r;
  *g = __fdiv_rn((L.df + 1.f) * r, denom);
  *w = fabsf(__fdiv_rn((L.df + 1.f) * (L.dfs2 - r * r), denom * denom));
  return loglik(L, y, f);
}

// Sums K values over the block; every thread gets the sums (in a fixed
// order, so every thread's copy is the same). Holds two __syncthreads.
template <int K>
__device__ __forceinline__ void block_sum(float (&x)[K], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int off = 16; off > 0; off >>= 1) x[k] += __shfl_xor_sync(0xffffffffu, x[k], off);
    if (lane == 0) scratch[warp * K + k] = x[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * K + k];
    x[k] = s;
  }
  __syncthreads();
}

// (r, c) with c <= r of packed lower-triangle index t (row-major)
__device__ __forceinline__ void tri_rc(int t, int* r, int* c) {
  int rr = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (rr * (rr + 1) / 2 > t) --rr;
  while ((rr + 1) * (rr + 2) / 2 <= t) ++rr;
  *r = rr;
  *c = t - rr * (rr + 1) / 2;
}

__host__ __device__ __forceinline__ int row_stride(int m) { return (m % 2 == 0) ? m + 1 : m; }

__host__ __device__ __forceinline__ size_t smem_floats(int n, int m) {
  // Lk, B, then y, g, |W| (n each), v, rhs, fwd, d (m each), trials (4m)
  return static_cast<size_t>(n + m) * row_stride(m) + 3 * n + 8 * m;
}

__global__ void __launch_bounds__(kThreads)
newton128_kernel(const float* __restrict__ Lk_g, const float* __restrict__ y_g,
                 const float* __restrict__ var_g, float* __restrict__ v_g, int n, int m,
                 int iters, int tag, float df, float host_const, float jitter) {
  extern __shared__ float smem[];
  __shared__ float s_red[kWarps * 2 * kTrials];
  __shared__ int s_failed;

  const int ld = row_stride(m);
  float* Lk = smem;            // [n][ld]
  float* Bm = Lk + n * ld;     // [m][ld], lower triangle
  float* y = Bm + m * ld;      // [n]
  float* g = y + n;            // [n]
  float* w = g + n;            // [n]
  float* v = w + n;            // [m]
  float* rhs = v + m;          // [m] grad psi, reduced in place by the forward solve
  float* fwd = rhs + m;        // [m] Lb^-1 grad psi
  float* d = fwd + m;          // [m] direction
  float* vt = d + m;           // [4][m] trial points

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* lk = Lk_g + static_cast<size_t>(b) * n * m;
  for (int idx = tid; idx < n * m; idx += kThreads) {
    const int i = idx / m;
    Lk[i * ld + (idx - i * m)] = lk[idx];
  }
  for (int i = tid; i < n; i += kThreads) y[i] = y_g[static_cast<size_t>(b) * n + i];
  for (int k = tid; k < m; k += kThreads) v[k] = 0.f;

  Lik L;
  L.tag = tag;
  L.df = df;
  const float scale = var_g[b];
  L.s2 = scale * scale;
  L.dfs2 = df * L.s2;
  L.konst = host_const - 0.5f * logf(L.s2);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // 1-3. f = Lk v, the likelihood terms, psi0
    float acc0[2] = {0.f, 0.f};  // sum ll, sum v^2
    for (int i = tid; i < n; i += kThreads) {
      float f = 0.f;
      for (int k = 0; k < m; ++k) f = fmaf(Lk[i * ld + k], v[k], f);
      acc0[0] += lik_terms(L, y[i], f, &g[i], &w[i]);
    }
    for (int k = tid; k < m; k += kThreads) acc0[1] += v[k] * v[k];
    if (tid == 0) s_failed = 0;
    block_sum<2>(acc0, s_red);
    const float psi0 = acc0[0] - 0.5f * acc0[1];

    // 4. grad psi = Lk^T g - v; B = Lk^T (|W| Lk), lower triangle
    for (int k = tid; k < m; k += kThreads) {
      float a = 0.f;
      for (int i = 0; i < n; ++i) a = fmaf(Lk[i * ld + k], g[i], a);
      rhs[k] = a - v[k];
    }
    for (int t = tid; t < m * (m + 1) / 2; t += kThreads) {
      int r, c;
      tri_rc(t, &r, &c);
      float a = 0.f;
      for (int i = 0; i < n; ++i) a = fmaf(Lk[i * ld + r], w[i] * Lk[i * ld + c], a);
      Bm[r * ld + c] = a;
    }
    __syncthreads();
    // block max of 1 + B_kk (NaN-propagating)
    float dmax = -__int_as_float(0x7f800000);  // -inf
    for (int k = tid; k < m; k += kThreads) dmax = nan_max(dmax, 1.f + Bm[k * ld + k]);
    for (int off = 16; off > 0; off >>= 1) dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
    if (lane == 0) s_red[warp] = dmax;
    __syncthreads();
    dmax = s_red[0];
    for (int q = 1; q < kWarps; ++q) dmax = nan_max(dmax, s_red[q]);
    __syncthreads();
    const float floor_ = jitter * (1.f + dmax);
    for (int k = tid; k < m; k += kThreads) {
      Bm[k * ld + k] = ((1.f + Bm[k * ld + k]) + floor_) + jitter;
    }
    __syncthreads();

    // 5. in-place lower Cholesky, right-looking, two barriers a column
    for (int j = 0; j < m; ++j) {
      const float djj = Bm[j * ld + j];
      if (!(djj > 0.f)) {  // not positive, or NaN: uniform across the block
        if (tid == 0) s_failed = 1;
        break;
      }
      const float piv = __fsqrt_rn(djj);
      for (int i = j + 1 + tid; i < m; i += kThreads) {
        Bm[i * ld + j] = __fdiv_rn(Bm[i * ld + j], piv);
      }
      __syncthreads();
      if (tid == 0) Bm[j * ld + j] = piv;
      const int q = m - j - 1;
      for (int t = tid; t < q * (q + 1) / 2; t += kThreads) {
        int r, c;
        tri_rc(t, &r, &c);
        r += j + 1;
        c += j + 1;
        Bm[r * ld + c] -= Bm[r * ld + j] * Bm[c * ld + j];
      }
      __syncthreads();
    }
    __syncthreads();
    const int failed = s_failed;
    __syncthreads();  // every thread has read the flag before it is reset
    if (failed) continue;  // uniform: keep v, as a NaN step would

    // 6. Lb fwd = grad psi (forward), Lb^T d = fwd (back), in warp 0
    if (warp == 0) {
      for (int j = 0; j < m; ++j) {
        const float x = __fdiv_rn(rhs[j], Bm[j * ld + j]);
        for (int i = j + 1 + lane; i < m; i += 32) rhs[i] -= Bm[i * ld + j] * x;
        if (lane == 0) fwd[j] = x;
        __syncwarp();
      }
      for (int j = m - 1; j >= 0; --j) {
        const float x = __fdiv_rn(fwd[j], Bm[j * ld + j]);
        for (int i = lane; i < j; i += 32) fwd[i] -= Bm[j * ld + i] * x;
        if (lane == 0) d[j] = x;
        __syncwarp();
      }
    }
    __syncthreads();

    // 7. psi at the four trial points
    for (int idx = tid; idx < kTrials * m; idx += kThreads) {
      const int a = idx / m, k = idx - a * m;
      vt[idx] = v[k] + step_size(a) * d[k];
    }
    __syncthreads();
    float acc[2 * kTrials];
#pragma unroll
    for (int a = 0; a < 2 * kTrials; ++a) acc[a] = 0.f;
    for (int idx = tid; idx < kTrials * n; idx += kThreads) {
      const int a = idx / n, i = idx - a * n;
      const float* va = vt + a * m;
      float f = 0.f;
      for (int k = 0; k < m; ++k) f = fmaf(Lk[i * ld + k], va[k], f);
      const float l = loglik(L, y[i], f);
#pragma unroll
      for (int q = 0; q < kTrials; ++q) acc[q] += (q == a) ? l : 0.f;
    }
    for (int idx = tid; idx < kTrials * m; idx += kThreads) {
      const int a = idx / m;
      const float x = vt[idx] * vt[idx];
#pragma unroll
      for (int q = 0; q < kTrials; ++q) acc[kTrials + q] += (q == a) ? x : 0.f;
    }
    block_sum<2 * kTrials>(acc, s_red);

    // 8. the ladder (every thread decides the same)
    const float tie_tol = 1e-5f * (1.f + fabsf(psi0));
    float best = psi0;
    int sel = -1;
#pragma unroll
    for (int a = 0; a < kTrials; ++a) {
      const float p = acc[a] - 0.5f * acc[kTrials + a];
      if (a == 0 ? (p >= best - tie_tol) : (p > best)) {
        best = p;
        sel = a;
      }
    }
    if (sel >= 0) {
      for (int k = tid; k < m; k += kThreads) v[k] = vt[sel * m + k];
    }
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
  const size_t bytes = smem_floats(n, m) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      newton128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  newton128_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      Lk, y, var, v, n, m, iters, tag, df, host_const, jitter);
  return static_cast<int>(cudaGetLastError());
}
