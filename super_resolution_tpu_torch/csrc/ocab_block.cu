// The attention half of a classic HAT OCAB, NHWC:
//
//   xn  = LN1(x)                                  (rounded to T)
//   q   = xn @ Wq + bq          per ws x ws window
//   kv  = xn @ Wkv + bkv        per ow x ow overlapping window, set to 0
//                               where the window leaves the image
//   o_h = softmax(q_h k_h^T * scale + RPB_h) v_h  (N x Nk per head)
//   out = concat_h(o_h) @ Wproj + bproj + rs * x
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_attention.py:
// fused_ocab_block (pallas_call at :683). As there (:591-602), the
// PROJECTED kv is zeroed outside the image, not the raw input: LN and the
// projection biases would otherwise leak into the border windows.
//
// What bounds it on the H100: per window at the flagship shape (N 256,
// Nk 576, C 180, 6 heads of 30) the kv projection is recomputed for the
// overlap window (2 * 576 * 180 * 360 = 75 MFLOP), the q and output
// projections add 33 MFLOP and attention 4 * 6 * 256 * 576 * 30 =
// 106 MFLOP, against ~0.3 MB of bf16 image reads: compute-bound. This first
// version runs every product as float32 FMA loops on the CUDA cores and is
// bound by them.
//
// Design: one block per window. The LayerNorm statistics of the Nk overlap
// tokens are computed once into shared memory and the normalised values
// are formed as the projections read them, so no normalised image exists.
// Per head, q (256 x 30), k and v (576 x 30 each) sit in shared memory as
// float32; scores are formed kQChunk query rows at a time (8 x 576). The
// head concat goes to a wrapper-allocated scratch image, and after a block
// barrier the block applies the output projection and the residual to its
// own window. Shared memory per block at the flagship shape: 195 kB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQChunk = 8;
constexpr int kMaxD = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ocab_block_kernel(const T* __restrict__ x, const T* __restrict__ lns,
                      const T* __restrict__ lnb, const T* __restrict__ wq,
                      const T* __restrict__ bq, const T* __restrict__ wkv,
                      const T* __restrict__ bkv, const T* __restrict__ wproj,
                      const T* __restrict__ bproj,
                      const float* __restrict__ bias, T* o_scr,
                      T* __restrict__ out, int H, int W, int C, int cq,
                      int heads, int ws, int ow, float scale, float eps,
                      float rs) {
  extern __shared__ float smem[];
  const int n = ws * ws, nk = ow * ow;
  const int d = cq / heads;
  const int pad = (ow - ws) / 2;
  const int nwx = W / ws;
  const int wid = blockIdx.x;
  const int b = blockIdx.y;
  const int wy = wid / nwx, wx = wid % nwx;

  float* q = smem;                   // n x d
  float* k = q + n * d;              // nk x d
  float* v = k + nk * d;             // nk x d
  float* sc = v + nk * d;            // kQChunk x nk
  float* mu = sc + kQChunk * nk;     // nk LN means
  float* rstd = mu + nk;             // nk LN reciprocal std
  int* kpix = reinterpret_cast<int*>(rstd + nk);  // nk pixels, -1 outside
  int* qpix = kpix + nk;                          // n pixels

  for (int t = threadIdx.x; t < nk; t += blockDim.x) {
    const int ky = wy * ws - pad + t / ow, kx = wx * ws - pad + t % ow;
    kpix[t] = (ky >= 0 && ky < H && kx >= 0 && kx < W)
                  ? (b * H + ky) * W + kx
                  : -1;
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    qpix[t] = (b * H + wy * ws + t / ws) * W + wx * ws + t % ws;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < nk; t += nwarps) {
    if (kpix[t] < 0) {  // warp-uniform
      if (lane == 0) mu[t] = rstd[t] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<long long>(kpix[t]) * C;
    float m, r;
    srk::warp_ln_stats([&](int c) { return srk::to_f(xr[c]); }, C, eps, m, r);
    if (lane == 0) {
      mu[t] = m;
      rstd[t] = r;
    }
  }
  __syncthreads();

  // LN1 of overlap token t, channel c, rounded to T as the reference casts
  auto xn = [&](int t, int c) {
    const float xv = srk::to_f(x[static_cast<long long>(kpix[t]) * C + c]);
    return srk::round_to<T>((xv - mu[t]) * rstd[t] * srk::to_f(lns[c]) +
                            srk::to_f(lnb[c]));
  };
  // query token t of the window is overlap token (t/ws + pad, t%ws + pad)
  auto q2k = [&](int t) { return (t / ws + pad) * ow + t % ws + pad; };

  for (int h = 0; h < heads; ++h) {
    srk::block_gemm<4, 2>(
        n, d, C, [&](int m, int c) { return xn(q2k(m), c); },
        [&](int c, int j) {
          return srk::to_f(wq[static_cast<long long>(c) * cq + h * d + j]);
        },
        [&](int m, int j, float acc) {
          q[m * d + j] = srk::round_to<T>(acc + srk::to_f(bq[h * d + j]));
        });
    srk::block_gemm<4, 2>(
        nk, 2 * d, C,
        [&](int m, int c) { return kpix[m] < 0 ? 0.f : xn(m, c); },
        [&](int c, int col) {
          const int off = col < d ? h * d + col : cq + h * d + col - d;
          return srk::to_f(wkv[static_cast<long long>(c) * 2 * cq + off]);
        },
        [&](int m, int col, float acc) {
          const int off = col < d ? h * d + col : cq + h * d + col - d;
          const float val =
              kpix[m] < 0 ? 0.f : srk::round_to<T>(acc + srk::to_f(bkv[off]));
          if (col < d)
            k[m * d + col] = val;
          else
            v[m * d + col - d] = val;
        });
    __syncthreads();

    const float* bh = bias + static_cast<long long>(h) * n * nk;
    srk::attend_head<T, kQChunk, kMaxD>(
        q, k, v, sc, n, nk, d, scale,
        [&](int i, int j) { return bh[static_cast<long long>(i) * nk + j]; },
        [&](int i, int t, float o) {
          o_scr[static_cast<long long>(qpix[i]) * cq + h * d + t] =
              srk::from_f<T>(o);
        });
  }

  srk::block_gemm<4, 4>(
      n, C, cq,
      [&](int m, int c) {
        return srk::to_f(o_scr[static_cast<long long>(qpix[m]) * cq + c]);
      },
      [&](int c, int col) {
        return srk::to_f(wproj[static_cast<long long>(c) * C + col]);
      },
      [&](int m, int col, float acc) {
        const long long e = static_cast<long long>(qpix[m]) * C + col;
        const float res = srk::to_f(x[e]);
        out[e] = srk::from_f<T>(acc + srk::to_f(bproj[col]) +
                                (rs == 1.f ? res : res * rs));
      });
}

size_t smem_bytes(int ws, int ow, int d) {
  const int n = ws * ws, nk = ow * ow;
  return sizeof(float) * (n * d + 2 * nk * d + kQChunk * nk + 2 * nk) +
         sizeof(int) * (nk + n);
}

template <typename T>
cudaError_t launch(const void* x, const void* lns, const void* lnb,
                   const void* wq, const void* bq, const void* wkv,
                   const void* bkv, const void* wproj, const void* bproj,
                   const float* bias, void* o_scr, void* out, int B, int H,
                   int W, int C, int cq, int heads, int ws, int ow,
                   float scale, float eps, float rs, cudaStream_t stream) {
  const int d = cq / heads;
  if (d > kMaxD || d * heads != cq || H % ws || W % ws || (ow - ws) % 2)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ws, ow, d);
  cudaError_t err = srk::set_smem(ocab_block_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  ocab_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lns),
      static_cast<const T*>(lnb), static_cast<const T*>(wq),
      static_cast<const T*>(bq), static_cast<const T*>(wkv),
      static_cast<const T*>(bkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), bias, static_cast<T*>(o_scr),
      static_cast<T*>(out), H, W, C, cq, heads, ws, ow, scale, eps, rs);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_ocab_block_smem(int ws, int ow, int d) {
  return static_cast<int>(smem_bytes(ws, ow, d));
}

// dtype: 0 float32, 1 bfloat16. bias (heads, ws^2, ow^2) is float32; o_scr
// is a (B, H, W, cq) scratch image of type dtype. Returns the cudaError_t
// of the launch.
extern "C" int sr_ocab_block(int dtype, const void* x, const void* lns,
                             const void* lnb, const void* wq, const void* bq,
                             const void* wkv, const void* bkv,
                             const void* wproj, const void* bproj,
                             const void* bias, void* o_scr, void* out, int B,
                             int H, int W, int C, int cq, int heads, int ws,
                             int ow, float scale, float eps, float rs,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<float>(x, lns, lnb, wq, bq, wkv, bkv, wproj, bproj, bf,
                         o_scr, out, B, H, W, C, cq, heads, ws, ow, scale,
                         eps, rs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, lns, lnb, wq, bq, wkv, bkv, wproj, bproj,
                                 bf, o_scr, out, B, H, W, C, cq, heads, ws,
                                 ow, scale, eps, rs, st);
  return cudaErrorInvalidValue;
}
