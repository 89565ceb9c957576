// SRFormer's permuted self-attention block with its q and output
// projections: per ws x ws window of x (B, H, W, C)
//
//   q = round(x W_q + b_q)                                (N x C, N = ws^2)
//   o_h = softmax(q_h k_h^T * scale + bias_h + mask_w) v_h per head, against
//         the window's compressed keys and values kv (nk x 2C, nk = N / 4,
//         channels [K (C) | V (C)], heads as slices of d = C / heads)
//   out = round(concat_h o_h) W_proj + b_proj, written in image layout
//   bias (heads, N, nk) float32; mask (nW, N, nk) float32 indexed by the
//   window's position in its image, or (1, N, nk), or none.
//
// Replaces the TPU kernel fused_psa_block of
// super_resolution_tpu/ops/pallas_attention.py (pallas_call at :1282, body
// _psa_block_kernel :1199-1234). The cast points are its own: q to the
// input dtype after the bias, p to the input dtype before P @ V, the head
// concat to the input dtype before the projection; every sum is float32.
// The kv projection and its 2 x 2 fold stay with the caller, as there.
//
// What bounds it on the H100: at SRFormer's chunk (four 144 x 144 tiles,
// 144 windows of N 576 against nk 144, C 180, 6 heads of d 30) a window is
// 2 * 2 * 576 * 180 * 180 = 75 MFLOP of projections and 4 * 576 * 144 * 180
// = 60 MFLOP of attention against 415 kB of bf16 x and out, 104 kB of kv
// and a 2 MB float32 bias that all windows share: 19 GFLOP (0.020 ms at the
// tensor cores' bf16 peak) against 77 MB, 89 MB with the shift mask (0.023
// and 0.026 ms at the HBM rate). The two bounds lie close, bytes ahead. C
// 180 and d 30 fit no MMA tile; every product here is a float32 FMA loop on
// the CUDA cores, which is what bounds this first version.
//
// Design: one block per (window, 16 query rows). The TPU grid is one
// program per window that holds the window, both weights and the whole
// bias in VMEM; on this card that would be 144 long blocks for 132 SMs,
// and 180 x 180 float32 weights (130 kB each) do not fit beside the tiles.
// A block keeps its 16 rows of x (then of the head concat), q split by
// head and padded to 16 or 32 columns, one head's k and v, a 16 x nk score
// tile and the reduction space: 87 kB at SRFormer's shape, two blocks an
// SM. The weights come from the L2 in slabs of 32 input rows, staged
// through the score tile's and the reduction space's memory, which are
// idle during a projection; each thread keeps a 4 x 3 piece of the 16 x C
// result in registers across the slabs. Windows are fastest in the grid,
// so blocks that run together read the same rows of the bias.
#include "attention_tiles.cuh"

namespace {

constexpr int kQT = 16;      // query rows of a block
constexpr int kSlab = 32;    // weight rows staged at a time
constexpr int kTM = 4, kTN = 3;  // outputs a thread owns in a projection

int pad_of(int d) { return d <= 16 ? 16 : 32; }

// floats the attention tile and a weight slab need; they share one region
__host__ __device__ inline int work_floats(int nk, int dp, int C) {
  const int attn = kQT * srk::score_stride(nk) + srk::kTileWarps * kQT * dp;
  const int slab = kSlab * C;
  return attn > slab ? attn : slab;
}

size_t smem_bytes(int nk, int dp, int C, int heads) {
  return sizeof(float) * (kQT * C + heads * kQT * dp +
                          2 * srk::round_up4(nk) * dp +
                          work_floats(nk, dp, C));
}

// slab[e] = w[e] for e < n, as float32. A slab is contiguous in the weight:
// where it starts on a 16-byte boundary a thread takes 16 bytes a load, so
// the block has the whole slab in flight in two or three loads a thread.
template <typename T>
__device__ __forceinline__ void stage_slab(float* slab,
                                           const T* __restrict__ w, int n) {
  constexpr int VEC = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(w) & 15ull) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    for (int e = threadIdx.x; e < n / VEC; e += blockDim.x) {
      const uint4 raw = src[e];
      const T* packed = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(slab + e * VEC + u) = make_float4(
            srk::to_f(packed[u]), srk::to_f(packed[u + 1]),
            srk::to_f(packed[u + 2]), srk::to_f(packed[u + 3]));
    }
    done = n / VEC * VEC;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x)
    slab[e] = srk::to_f(w[e]);
}

// epi(m, n, sum_k a[m * C + k] * w[k * C + n]) for the kQT x C tile a in
// shared memory and the (C, C) weight w in device memory, staged through
// slab (kSlab x C floats). The last slab ends with a block barrier, so a
// and slab may be overwritten right after; what epi writes is not covered
// by it.
template <typename T, typename FE>
__device__ __forceinline__ void project_tile(const float* a,
                                             const T* __restrict__ w, int C,
                                             float* slab, FE epi) {
  const int tiles_n = (C + kTN - 1) / kTN;
  const int tiles = (kQT / kTM) * tiles_n;
  for (int t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool active = t < tiles;
    const int m0 = active ? (t / tiles_n) * kTM : 0;
    const int n0 = active ? (t % tiles_n) * kTN : 0;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kSlab) {
      const int ks = min(kSlab, C - k0);
      stage_slab<T>(slab, w + static_cast<long long>(k0) * C, ks * C);
      __syncthreads();
      if (active) {
        for (int k = 0; k < ks; ++k) {
          float av[kTM], bv[kTN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a[(m0 + i) * C + k0 + k];
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            bv[j] = (n0 + j < C) ? slab[k * C + n0 + j] : 0.f;
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (n0 + j < C) epi(m0 + i, n0 + j, acc[i][j]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    psa_block_kernel(const T* __restrict__ x, const T* __restrict__ w_q,
                     const T* __restrict__ b_q, const T* __restrict__ w_proj,
                     const T* __restrict__ b_proj, const T* __restrict__ kv,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, int n_mask,
                     T* __restrict__ out, int windows, int H, int W, int C,
                     int heads, int ws, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = ws * ws;
  const int nk = n / 4;
  const int nk4 = srk::round_up4(nk);
  const int d = C / heads;
  const int widx = blockIdx.x % windows;
  const int q0 = (blockIdx.x / windows) * kQT;
  const int qt = min(kQT, n - q0);
  const srk::Window win = srk::window_of(widx, H, W, ws);

  float* xo = smem;                        // kQT x C: x rows, then the concat
  float* qs = xo + kQT * C;                // heads x kQT x DP
  float* ks = qs + heads * kQT * DP;       // nk4 x DP
  float* vs = ks + nk4 * DP;               // nk4 x DP
  float* work = vs + nk4 * DP;             // score tile + reduction | slab
  float* sc = work;
  float* red = sc + kQT * srk::score_stride(nk);

  // the block's rows of x, eight threads a row; rows past the window and
  // the padding columns of q are zero
  for (int e = threadIdx.x; e < kQT * 8; e += blockDim.x) {
    const int i = e >> 3;
    const T* p = i < qt ? x + win.pixel(q0 + i) * C : nullptr;
#pragma unroll 8
    for (int c = e & 7; c < C; c += 8)
      xo[i * C + c] = p != nullptr ? srk::to_f(p[c]) : 0.f;
  }
  for (int e = threadIdx.x; e < heads * kQT * DP; e += blockDim.x) qs[e] = 0.f;
  __syncthreads();

  project_tile<T>(xo, w_q, C, work, [&](int m, int c, float acc) {
    qs[((c / d) * kQT + m) * DP + c % d] =
        srk::round_to<T>(acc + srk::to_f(b_q[c]));
  });

  const int nw_img = (H / ws) * (W / ws);
  const float* mw =
      mask == nullptr
          ? nullptr
          : mask + (static_cast<long long>(n_mask == 1 ? 0 : widx % nw_img) *
                        n + q0) * nk;
  const T* kvw = kv + static_cast<long long>(widx) * nk * 2 * C;
  for (int h = 0; h < heads; ++h) {
    // the previous head's tile, and the projection, ended with a barrier
    srk::load_rows_any<T, DP>(ks, nk, nk4, d, [&](int j) {
      return kvw + static_cast<long long>(j) * 2 * C + h * d;
    });
    srk::load_rows_any<T, DP>(vs, nk, nk4, d, [&](int j) {
      return kvw + static_cast<long long>(j) * 2 * C + C + h * d;
    });
    __syncthreads();
    const float* bh = bias + (static_cast<long long>(h) * n + q0) * nk;
    srk::attend_tile<T, DP, kQT>(
        qs + h * kQT * DP, qt, ks, vs, nk, sc, red, d, scale,
        [&](int i, int j) {
          const int at = i * nk + j;
          return mw == nullptr ? bh[at] : bh[at] + mw[at];
        },
        [&](int i, int t, float o) {
          xo[i * C + h * d + t] = srk::round_to<T>(o);
        });
  }

  project_tile<T>(xo, w_proj, C, work, [&](int m, int c, float acc) {
    if (m < qt)
      out[win.pixel(q0 + m) * C + c] =
          srk::from_f<T>(acc + srk::to_f(b_proj[c]));
  });
}

template <typename T, int DP>
cudaError_t launch(const void* x, const void* w_q, const void* b_q,
                   const void* w_proj, const void* b_proj, const void* kv,
                   const float* bias, const float* mask, int n_mask, void* out,
                   int B, int H, int W, int C, int heads, int ws, float scale,
                   cudaStream_t stream) {
  const int n = ws * ws;
  const int windows = B * (H / ws) * (W / ws);
  const size_t smem = smem_bytes(n / 4, DP, C, heads);
  cudaError_t err = srk::set_smem(psa_block_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(windows) * ((n + kQT - 1) / kQT);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  psa_block_kernel<T, DP>
      <<<static_cast<unsigned>(blocks), srk::kTileThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w_q),
          static_cast<const T*>(b_q), static_cast<const T*>(w_proj),
          static_cast<const T*>(b_proj), static_cast<const T*>(kv), bias,
          mask, n_mask, static_cast<T*>(out), windows, H, W, C, heads, ws,
          scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block needs for window ws, C channels in
// `heads` heads; the wrapper holds this against the card's limit.
extern "C" int sr_psa_block_smem(int ws, int C, int heads) {
  return static_cast<int>(
      smem_bytes(ws * ws / 4, pad_of(C / heads), C, heads));
}

// dtype: 0 float32, 1 bfloat16. x, out (B, H, W, C); w_q, w_proj (C, C) as
// (in, out); b_q, b_proj (C); kv (B * nW, ws^2 / 4, 2C); bias (heads, ws^2,
// ws^2 / 4) float32; mask (n_mask, ws^2, ws^2 / 4) float32 with n_mask 1 or
// the windows of one image, or null for no mask. Head dims up to 32, ws
// even. Returns the cudaError_t of the launch.
extern "C" int sr_psa_block(int dtype, const void* x, const void* w_q,
                            const void* b_q, const void* w_proj,
                            const void* b_proj, const void* kv,
                            const void* bias, const void* mask, int n_mask,
                            void* out, int B, int H, int W, int C, int heads,
                            int ws, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const float* mf = static_cast<const float*>(mask);
  if (heads < 1 || C % heads || ws < 2 || ws % 2 || H % ws || W % ws ||
      B < 1 || dtype < 0 || dtype > 1 || C / heads > 32)
    return cudaErrorInvalidValue;
  if (mf != nullptr && n_mask != 1 && n_mask != (H / ws) * (W / ws))
    return cudaErrorInvalidValue;
  const bool narrow = C / heads <= 16;
  if (dtype == 0)
    return narrow ? launch<float, 16>(x, w_q, b_q, w_proj, b_proj, kv, bf, mf,
                                      n_mask, out, B, H, W, C, heads, ws,
                                      scale, st)
                  : launch<float, 32>(x, w_q, b_q, w_proj, b_proj, kv, bf, mf,
                                      n_mask, out, B, H, W, C, heads, ws,
                                      scale, st);
  return narrow ? launch<__nv_bfloat16, 16>(x, w_q, b_q, w_proj, b_proj, kv,
                                            bf, mf, n_mask, out, B, H, W, C,
                                            heads, ws, scale, st)
                : launch<__nv_bfloat16, 32>(x, w_q, b_q, w_proj, b_proj, kv,
                                            bf, mf, n_mask, out, B, H, W, C,
                                            heads, ws, scale, st);
}
