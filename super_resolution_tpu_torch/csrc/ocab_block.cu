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
// fused_ocab_block (pallas_call at :683, body _ocab_block_kernel
// :554-628). As there (:591-602), the PROJECTED kv is zeroed outside the
// image, not the raw input: LN and the projection biases would otherwise
// leak into the border windows. Cq < C and rs != 1 take a head group's
// weight slice, as the tensor-parallel callers do.
//
// What bounds it on the H100: at the flagship chunk (four 160 x 160 tiles,
// C 180, 400 windows of N 256 against Nk 576, 6 heads of 30) the q, kv and
// output projections are 2 * 102400 * 180 * 720 = 26.5 GFLOP with kv made
// once a pixel, and the attention 4 * 400 * 6 * 256 * 576 * 30 = 42.5
// GFLOP: 0.070 ms on the tensor cores, against 74 MB of bf16 image in and
// out (0.022 ms) and 354 M exponentials (0.091 ms on the special-function
// units).
//
// In bf16 it is three kernels behind one entry, every product on the
// tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums):
//   mma_ln_proj_kernel        a block per 128 pixels (mma_proj.cuh): LN1
//                             in float32 (two passes, the TPU's cast to
//                             bf16), then xn Wq + bq and xn Wkv + bkv,
//                             each rounded once, into the caller's q (B,
//                             H, W, Cq) and kv (B, H, W, 2Cq) scratch
//                             images;
//   mma_ocab_attention_kernel the attention of fused_ocab_attention
//                             (ocab_attention.cu, through its C entry) on
//                             those images: a key outside the image reads
//                             a zero row, the projected kv's zero;
//   mma_proj_residual_kernel  a block per 128 pixels: concat Wproj +
//                             bproj + rs * x in float32, rounded once.
// The TPU kernel recomputes kv for every overlap window (2.25 times its
// products) to spare an HBM round trip; a window's projected kv (576 x 360
// bf16, 415 kB) does not fit a block here, so kv is made once a pixel and
// goes through the HBM: 74 MB written and read again, about 0.04 ms. The
// cast points of the attention are the online softmax's (p rounded
// unnormalised, the output divided by the float32 denominator), where the
// TPU kernel normalises p before its cast (:613-617).
//
// In float32 it is the FMA kernel below, the exact check of the algorithm
// on the card; its entry refuses bf16. Design: one block per window. The
// LayerNorm statistics of the Nk overlap tokens are computed once into
// shared memory and the normalised values are formed as the projections
// read them, so no normalised image exists. Per head, q (256 x 30), k and
// v (576 x 30 each) sit in shared memory as float32; scores are formed
// kQChunk query rows at a time (8 x 576). The head concat goes to a
// wrapper-allocated scratch image, and after a block barrier the block
// applies the output projection and the residual to its own window. Shared
// memory per block at the flagship shape: 195 kB.
#include <stdint.h>

#include "common.cuh"
#include "mma_proj.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQChunk = 8;
constexpr int kMaxD = 32;

__global__ void __launch_bounds__(kThreads)
    ocab_block_kernel(const float* __restrict__ x,
                      const float* __restrict__ lns,
                      const float* __restrict__ lnb,
                      const float* __restrict__ wq,
                      const float* __restrict__ bq,
                      const float* __restrict__ wkv,
                      const float* __restrict__ bkv,
                      const float* __restrict__ wproj,
                      const float* __restrict__ bproj,
                      const float* __restrict__ bias, float* o_scr,
                      float* __restrict__ out, int H, int W, int C, int cq,
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
    const float* xr = x + static_cast<long long>(kpix[t]) * C;
    float m, r;
    srk::warp_ln_stats([&](int c) { return xr[c]; }, C, eps, m, r);
    if (lane == 0) {
      mu[t] = m;
      rstd[t] = r;
    }
  }
  __syncthreads();

  // LN1 of overlap token t, channel c
  auto xn = [&](int t, int c) {
    const float xv = x[static_cast<long long>(kpix[t]) * C + c];
    return (xv - mu[t]) * rstd[t] * lns[c] + lnb[c];
  };
  // query token t of the window is overlap token (t/ws + pad, t%ws + pad)
  auto q2k = [&](int t) { return (t / ws + pad) * ow + t % ws + pad; };

  for (int h = 0; h < heads; ++h) {
    srk::block_gemm<4, 2>(
        n, d, C, [&](int m, int c) { return xn(q2k(m), c); },
        [&](int c, int j) {
          return wq[static_cast<long long>(c) * cq + h * d + j];
        },
        [&](int m, int j, float acc) { q[m * d + j] = acc + bq[h * d + j]; });
    srk::block_gemm<4, 2>(
        nk, 2 * d, C,
        [&](int m, int c) { return kpix[m] < 0 ? 0.f : xn(m, c); },
        [&](int c, int col) {
          const int off = col < d ? h * d + col : cq + h * d + col - d;
          return wkv[static_cast<long long>(c) * 2 * cq + off];
        },
        [&](int m, int col, float acc) {
          const int off = col < d ? h * d + col : cq + h * d + col - d;
          const float val = kpix[m] < 0 ? 0.f : acc + bkv[off];
          if (col < d)
            k[m * d + col] = val;
          else
            v[m * d + col - d] = val;
        });
    __syncthreads();

    const float* bh = bias + static_cast<long long>(h) * n * nk;
    srk::attend_head<float, kQChunk, kMaxD>(
        q, k, v, sc, n, nk, d, scale,
        [&](int i, int j) { return bh[static_cast<long long>(i) * nk + j]; },
        [&](int i, int t, float o) {
          o_scr[static_cast<long long>(qpix[i]) * cq + h * d + t] = o;
        });
  }

  srk::block_gemm<4, 4>(
      n, C, cq,
      [&](int m, int c) {
        return o_scr[static_cast<long long>(qpix[m]) * cq + c];
      },
      [&](int c, int col) {
        return wproj[static_cast<long long>(c) * C + col];
      },
      [&](int m, int col, float acc) {
        const long long e = static_cast<long long>(qpix[m]) * C + col;
        out[e] = acc + bproj[col] + (rs == 1.f ? x[e] : x[e] * rs);
      });
}

size_t smem_bytes(int ws, int ow, int d) {
  const int n = ws * ws, nk = ow * ow;
  return sizeof(float) * (n * d + 2 * nk * d + kQChunk * nk + 2 * nk) +
         sizeof(int) * (nk + n);
}

bool bad_shape(int B, int H, int W, int C, int cq, int heads, int ws,
               int ow) {
  return heads < 1 || cq % heads || cq / heads > kMaxD || C < 1 || ws < 1 ||
         H % ws || W % ws || B < 1 || ow < ws || (ow - ws) % 2;
}

cudaError_t launch(const float* x, const float* lns, const float* lnb,
                   const float* wq, const float* bq, const float* wkv,
                   const float* bkv, const float* wproj, const float* bproj,
                   const float* bias, float* o_scr, float* out, int B, int H,
                   int W, int C, int cq, int heads, int ws, int ow,
                   float scale, float eps, float rs, cudaStream_t stream) {
  const size_t smem = smem_bytes(ws, ow, cq / heads);
  cudaError_t err = srk::set_smem(ocab_block_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  ocab_block_kernel<<<grid, kThreads, smem, stream>>>(
      x, lns, lnb, wq, bq, wkv, bkv, wproj, bproj, bias, o_scr, out, H, W, C,
      cq, heads, ws, ow, scale, eps, rs);
  return cudaGetLastError();
}

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;

struct LnProjArgs {
  const bf16* x;
  const bf16* lns;
  const bf16* lnb;
  const bf16* wq;
  const bf16* bq;
  const bf16* wkv;
  const bf16* bkv;
  mma::RowsOut q;   // (M, cq)
  mma::RowsOut kv;  // (M, 2 cq)
  long long m;
  int C, cq;
  float eps;
  bool vec_x, vec_w;  // 8-byte copies of x rows; of the weights' rows
};

// q = round(LN1(x) Wq + bq), kv = round(LN1(x) Wkv + bkv) for
// kProjRows pixels: the A tile normalised once, then two products.
__global__ void __launch_bounds__(mma::kProjThreads)
    mma_ln_proj_kernel(LnProjArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C;
  const long long row0 = static_cast<long long>(blockIdx.x) * mma::kProjRows;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + 2 * mma::kProjRows * mma::a_stride(C);
  mma::stage_rows(at, a.x, C, row0, a.m, C, a.vec_x);
  const bf16 zero = __float2bfloat16(0.f);
  // xn w + b of n output columns into out
  auto product = [&](const bf16* w, const bf16* b, int n, mma::RowsOut out,
                     auto prologue) {
    out.row0 = row0;
    mma::project_rows(
        at, C, n,
        [&](int r, int c) { return w + static_cast<long long>(r) * n + c; },
        a.vec_w, stages, prologue,
        [&](int, int c) {
          return mma::pack(b[c], c + 1 < n ? b[c + 1] : zero);
        },
        [&](int, int, float v0, float v1, uint32_t b2) {
          const float2 bb = mma::unpack(b2);
          return mma::pack(v0 + bb.x, v1 + bb.y);
        },
        out);
  };
  product(a.wq, a.bq, a.cq, a.q,
          [&] { mma::layer_norm_rows(at, C, a.lns, a.lnb, a.eps); });
  // the q product's last stage is read until here
  __syncthreads();
  product(a.wkv, a.bkv, 2 * a.cq, a.kv, [] {});
}

struct ProjResArgs {
  const bf16* o;      // (M, cq), the head concat
  const bf16* wproj;  // (cq, C)
  const bf16* bproj;
  const bf16* x;      // (M, C), the residual
  mma::RowsOut out;   // (M, C)
  long long m;
  int C, cq;
  float rs;
  bool vec_o, vec_w;
};

// out = round(o Wproj + bproj + rs * x) for kProjRows pixels.
__global__ void __launch_bounds__(mma::kProjThreads)
    mma_proj_residual_kernel(ProjResArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, cq = a.cq;
  const long long row0 = static_cast<long long>(blockIdx.x) * mma::kProjRows;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + 2 * mma::kProjRows * mma::a_stride(cq);
  mma::stage_rows(at, a.o, cq, row0, a.m, cq, a.vec_o);
  mma::RowsOut out = a.out;
  out.row0 = row0;
  const bf16 zero = __float2bfloat16(0.f);
  mma::project_rows(
      at, cq, C,
      [&](int r, int c) { return a.wproj + static_cast<long long>(r) * C + c; },
      a.vec_w, stages, [] {},
      [&](int r, int c) {  // the residual's pair
        const long long row = row0 + r;
        if (row >= a.m) return 0u;
        const bf16* xr = a.x + row * C + c;
        return mma::pack(xr[0], c + 1 < C ? xr[1] : zero);
      },
      [&](int, int c, float v0, float v1, uint32_t x2) {
        const float2 res = mma::unpack(x2);
        const float o0 = v0 + __bfloat162float(a.bproj[c]) +
                         (a.rs == 1.f ? res.x : res.x * a.rs);
        if (c + 1 >= C) return mma::pack(o0, 0.f);
        const float o1 = v1 + __bfloat162float(a.bproj[c + 1]) +
                         (a.rs == 1.f ? res.y : res.y * a.rs);
        return mma::pack(o0, o1);
      },
      out);
}

}  // namespace tc

}  // namespace

// fused_ocab_attention's tensor-core entry (ocab_attention.cu), the middle
// of the bf16 OCAB.
extern "C" int sr_mma_ocab_attention(const void* q_img, const void* kv_img,
                                     const void* bias, void* out, int B,
                                     int H, int W, int c, int heads, int ws,
                                     int ow, float scale, void* stream);

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_ocab_block_smem(int ws, int ow, int d) {
  return static_cast<int>(smem_bytes(ws, ow, d));
}

// The most dynamic shared memory a block of the two projection kernels of
// the bf16 OCAB needs (the attention's is sr_mma_attention_smem's).
extern "C" int sr_mma_ocab_block_smem(int C, int cq) {
  const int a = srk::mma::proj_smem_bytes(C), b = srk::mma::proj_smem_bytes(cq);
  return a > b ? a : b;
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_ocab_block's. bias (heads, ws^2, ow^2) is float32; o_scr is a (B,
// H, W, cq) float32 scratch image. Returns the cudaError_t of the launch.
extern "C" int sr_ocab_block(int dtype, const void* x, const void* lns,
                             const void* lnb, const void* wq, const void* bq,
                             const void* wkv, const void* bkv,
                             const void* wproj, const void* bproj,
                             const void* bias, void* o_scr, void* out, int B,
                             int H, int W, int C, int cq, int heads, int ws,
                             int ow, float scale, float eps, float rs,
                             void* stream) {
  if (dtype != 0 || bad_shape(B, H, W, C, cq, heads, ws, ow))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return launch(f(x), f(lns), f(lnb), f(wq), f(bq), f(wkv), f(bkv), f(wproj),
                f(bproj), f(bias), static_cast<float*>(o_scr),
                static_cast<float*>(out), B, H, W, C, cq, heads, ws, ow,
                scale, eps, rs, static_cast<cudaStream_t>(stream));
}

// fused_ocab_block in bf16 on the tensor cores: operands as
// sr_ocab_block's in bf16 (bias float32); q_scr (B, H, W, cq), kv_scr (B,
// H, W, 2 cq) and o_scr (B, H, W, cq) are bf16 scratch images. Launches
// mma_ln_proj_kernel, the tensor-core attention of fused_ocab_attention and
// mma_proj_residual_kernel in turn on the stream. Returns the first
// cudaError_t that is not cudaSuccess, or cudaSuccess.
extern "C" int sr_mma_ocab_block(const void* x, const void* lns,
                                 const void* lnb, const void* wq,
                                 const void* bq, const void* wkv,
                                 const void* bkv, const void* wproj,
                                 const void* bproj, const void* bias,
                                 void* q_scr, void* kv_scr, void* o_scr,
                                 void* out, int B, int H, int W, int C,
                                 int cq, int heads, int ws, int ow,
                                 float scale, float eps, float rs,
                                 void* stream) {
  namespace mma = srk::mma;
  using bf16 = __nv_bfloat16;
  if (bad_shape(B, H, W, C, cq, heads, ws, ow)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto aligned8 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
  };
  const long long m = static_cast<long long>(B) * H * W;
  const int blocks = static_cast<int>((m + mma::kProjRows - 1) /
                                      mma::kProjRows);

  tc::LnProjArgs p;
  p.x = b16(x);
  p.lns = b16(lns);
  p.lnb = b16(lnb);
  p.wq = b16(wq);
  p.bq = b16(bq);
  p.wkv = b16(wkv);
  p.bkv = b16(bkv);
  p.q = mma::rows_out(q_scr, m, cq);
  p.kv = mma::rows_out(kv_scr, m, 2 * cq);
  p.m = m;
  p.C = C;
  p.cq = cq;
  p.eps = eps;
  // rows of C, cq and 2 cq values: whole 8-byte pieces where both are
  // multiples of 4
  p.vec_x = C % 4 == 0 && aligned8(x);
  p.vec_w = cq % 4 == 0 && aligned8(wq) && aligned8(wkv);
  int smem = mma::proj_smem_bytes(C);
  cudaError_t err = srk::set_smem(tc::mma_ln_proj_kernel, smem);
  if (err != cudaSuccess) return err;
  tc::mma_ln_proj_kernel<<<blocks, mma::kProjThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = static_cast<cudaError_t>(sr_mma_ocab_attention(
      q_scr, kv_scr, bias, o_scr, B, H, W, cq, heads, ws, ow, scale, stream));
  if (err != cudaSuccess) return err;

  tc::ProjResArgs r;
  r.o = static_cast<const bf16*>(o_scr);
  r.wproj = b16(wproj);
  r.bproj = b16(bproj);
  r.x = b16(x);
  r.out = mma::rows_out(out, m, C);
  r.m = m;
  r.C = C;
  r.cq = cq;
  r.rs = rs;
  r.vec_o = cq % 4 == 0 && aligned8(o_scr);
  r.vec_w = C % 4 == 0 && aligned8(wproj);
  smem = mma::proj_smem_bytes(cq);
  err = srk::set_smem(tc::mma_proj_residual_kernel, smem);
  if (err != cudaSuccess) return err;
  tc::mma_proj_residual_kernel<<<blocks, mma::kProjThreads, smem, st>>>(r);
  return cudaGetLastError();
}
