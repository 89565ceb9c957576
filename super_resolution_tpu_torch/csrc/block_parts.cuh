// The two halves of a classic HAT block as device functions, shared by the
// kernels that run them apart (msa_block.cu, mlp_tail.cu) and the one that
// runs them together (hab_block.cu).
#pragma once

#include "common.cuh"

namespace srk {

constexpr int kMsaQChunk = 16;  // query rows whose scores exist at a time
constexpr int kMsaMaxD = 32;    // largest head dim
constexpr int kTailRows = 32;   // pixels an MLP tail takes at a time

// Floats of shared memory msa_window_heads works in: one head's q, k and v
// and kMsaQChunk score rows of a window of n tokens at head dim d.
__host__ __device__ inline size_t msa_heads_floats(int n, int d) {
  return static_cast<size_t>(3) * n * d + kMsaQChunk * n;
}

// Floats of shared memory mlp_tail_rows works in beside its input: the
// block input, its LayerNorm and gelu(fc1) of kTailRows pixels.
__host__ __device__ inline size_t mlp_tail_floats(int C, int hid) {
  return static_cast<size_t>(kTailRows) * (2 * C + hid);
}

// The attention of one window up to the head concat, by the whole block:
// per head, qkv = x Wqkv + b (rounded to T) of the window's n tokens, read
// at pixels src[t], then softmax(q k^T * scale + bias_h + mk) v, written
// rounded to T into o_scr at pixels dst[t], channels h * d + j. mk is the
// window's (n, n) mask or null for none. work: msa_heads_floats(n, d)
// floats. Ends with a block barrier: o_scr's rows of this window are then
// visible to every thread of the block, and work may be overwritten.
template <typename T>
__device__ __forceinline__ void msa_window_heads(
    const T* __restrict__ x, const T* __restrict__ wqkv,
    const T* __restrict__ bqkv, const float* __restrict__ bias,
    const float* __restrict__ mk, T* o_scr, const int* src, const int* dst,
    float* work, int n, int cin, int cloc, int heads, float scale) {
  const int d = cloc / heads;
  float* q = work;        // n x d
  float* k = q + n * d;   // n x d
  float* v = k + n * d;   // n x d
  float* sc = v + n * d;  // kMsaQChunk x n scores / probabilities
  for (int h = 0; h < heads; ++h) {
    // q, k, v of head h: columns part * cloc + h * d + j of the projection
    block_gemm<4, 2>(
        n, 3 * d, cin,
        [&](int m, int c) {
          return to_f(x[static_cast<long long>(src[m]) * cin + c]);
        },
        [&](int c, int col) {
          const int part = col / d;
          return to_f(wqkv[static_cast<long long>(c) * 3 * cloc +
                           part * cloc + h * d + col % d]);
        },
        [&](int m, int col, float acc) {
          const int part = col / d, j = col % d;
          const float val =
              round_to<T>(acc + to_f(bqkv[part * cloc + h * d + j]));
          (part == 0 ? q : part == 1 ? k : v)[m * d + j] = val;
        });
    __syncthreads();

    const float* bh = bias + static_cast<long long>(h) * n * n;
    attend_head<T, kMsaQChunk, kMsaMaxD>(
        q, k, v, sc, n, n, d, scale,
        [&](int i, int j) {
          const long long e = static_cast<long long>(i) * n + j;
          return mk ? bh[e] + mk[e] : bh[e];
        },
        [&](int i, int t, float o) {
          o_scr[static_cast<long long>(dst[i]) * cloc + h * d + t] =
              from_f<T>(o);
        });
  }
}

// out = rs * x + fc2(gelu(fc1(LN(x)))) on rows <= kTailRows pixels whose
// float32 input the caller has put in xs (rows x C) before a block barrier.
// ys (rows x C) takes LN(x) rounded to T, as the reference casts before
// fc1, gs (rows x hid) gelu(fc1) rounded to T before fc2, so the hidden
// activation never reaches device memory. GELU is the exact erff form.
// store(m, n, value) gets channel n of row m. No barrier at the end: the
// caller places one before it overwrites xs.
template <typename T, typename FS>
__device__ __forceinline__ void mlp_tail_rows(
    const float* xs, float* ys, float* gs, int rows, int C, int hid,
    const T* __restrict__ gamma, const T* __restrict__ beta,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2, float eps, float rs,
    FS store) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    const float* xr = xs + r * C;
    float mu, rstd;
    warp_ln_stats([&](int c) { return xr[c]; }, C, eps, mu, rstd);
    for (int c = lane; c < C; c += 32)
      ys[r * C + c] =
          round_to<T>((xr[c] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
  }
  __syncthreads();

  block_gemm<4, 4>(
      rows, hid, C, [&](int m, int k) { return ys[m * C + k]; },
      [&](int k, int n) { return to_f(w1[static_cast<long long>(k) * hid + n]); },
      [&](int m, int n, float acc) {
        const float h = acc + to_f(b1[n]);
        const float g = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
        gs[m * hid + n] = round_to<T>(g);
      });
  __syncthreads();

  block_gemm<4, 4>(
      rows, C, hid, [&](int m, int k) { return gs[m * hid + k]; },
      [&](int k, int n) { return to_f(w2[static_cast<long long>(k) * C + n]); },
      [&](int m, int n, float acc) {
        const float x = xs[m * C + n];
        store(m, n, acc + to_f(b2[n]) + (rs == 1.f ? x : x * rs));
      });
}

}  // namespace srk
