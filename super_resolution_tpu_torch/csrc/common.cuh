// Shared device helpers of the port's kernels: dtype conversion, the cast
// points of the reference, warp reductions, LayerNorm statistics, a
// block-wide GEMM loop and one head of window attention.
//
// Every kernel is templated on the activation type T (float or
// __nv_bfloat16). Arithmetic runs in float32; `round_to<T>` reproduces a
// cast to T at the places where the JAX kernels cast.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace srk {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

// v after a cast to T and back to float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm statistics of one row of C values, taken by one warp: at(c)
// returns channel c as float. Two passes (mean, then centred squares), as
// the reference computes them; every lane gets both results.
template <typename F>
__device__ __forceinline__ void warp_ln_stats(F at, int C, float eps,
                                              float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += at(c);
  mu = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dlt = at(c) - mu;
    sq += dlt * dlt;
  }
  rstd = rsqrtf(warp_sum(sq) / C + eps);
}

// GELU with the TPU kernels' erf, Abramowitz and Stegun 7.1.26 (error
// < 1.5e-7; pallas_ffn.py:298-306, pallas_hab.py:31-41), the reciprocal
// and exponential on the special-function unit.
__device__ __forceinline__ float gelu_as(float h) {
  const float z = h * 0.70710678118654752f, az = fabsf(z);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * __expf(-az * az);
  return 0.5f * h * (1.f + copysignf(e, z));
}

// (e / n, e % n) of e = start + k * step for k = 0, 1, ..., advanced without a
// division: in a block-strided loop over a runtime width, the index
// arithmetic would otherwise cost more than the work (20 instructions a
// division against a few FMAs or one copy).
struct DivMod {
  int q, r, dq, dr, n;
  __device__ __forceinline__ DivMod(int start, int step, int n_)
      : q(start / n_), r(start % n_), dq(step / n_), dr(step % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= n) {
      r -= n;
      ++q;
    }
  }
};

// Block-wide C[M, N] = A[M, K] @ B[K, N] with float32 accumulation.
// a_at(m, k) and b_at(k, n) return operands as float; epi(m, n, acc) gets
// each finished sum. Each thread owns TM x TN output tiles, strided over
// the block. Plain FMA loops, for the float32 kernels: they are the exact
// check, not the fast route (bf16 runs its products on the tensor cores).
template <int TM, int TN, typename FA, typename FB, typename FE>
__device__ __forceinline__ void block_gemm(int M, int N, int K, FA a_at,
                                           FB b_at, FE epi) {
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int m0 = (t / tiles_n) * TM;
    const int n0 = (t % tiles_n) * TN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (m0 + i < M) ? a_at(m0 + i, k) : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (n0 + j < N) ? b_at(k, n0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

// Row-wise softmax of rows[r * n + j] for r < n_rows, one warp per row,
// written back as probabilities rounded to T (the reference casts p to
// v's dtype before P @ V). Division by the sum, as the reference divides.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* rows, int n_rows, int n) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < n_rows; r += nwarps) {
    float* row = rows + r * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
}

// One head of window attention, by the whole block:
//   o = softmax(q k^T * scale + bias) v,  q (n x d), k and v (nk x d),
// all float32 in shared memory. Scores are formed QC query rows at a time
// in sc (QC x nk floats), so the n x nk matrix never exists whole.
// bias_at(i, j) returns the additive float32 term of query i and key j;
// store(i, t, o) gets channel t of query i's output. The probabilities are
// rounded to T before P @ V, as the reference casts them. Ends with a
// block barrier, so q, k, v and sc may be overwritten right after.
template <typename T, int QC, int MAXD, typename FB, typename FS>
__device__ __forceinline__ void attend_head(const float* q, const float* k,
                                            const float* v, float* sc, int n,
                                            int nk, int d, float scale,
                                            FB bias_at, FS store) {
  for (int q0 = 0; q0 < n; q0 += QC) {
    const int qc = min(QC, n - q0);
    for (int j = threadIdx.x; j < nk; j += blockDim.x) {
      float kr[MAXD];
#pragma unroll
      for (int t = 0; t < MAXD; ++t) kr[t] = (t < d) ? k[j * d + t] : 0.f;
      for (int i = 0; i < qc; ++i) {
        const float* qi = q + (q0 + i) * d;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < MAXD; ++t)
          if (t < d) acc = fmaf(qi[t], kr[t], acc);
        sc[i * nk + j] = acc * scale + bias_at(q0 + i, j);
      }
    }
    __syncthreads();
    softmax_rows<T>(sc, qc, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < qc * d; e += blockDim.x) {
      const int i = e / d, t = e % d;
      const float* pr = sc + i * nk;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], v[j * d + t], acc);
      store(q0 + i, t, acc);
    }
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB has to be granted per kernel.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace srk
