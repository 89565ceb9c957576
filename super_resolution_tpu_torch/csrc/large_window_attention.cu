// Unshifted window self-attention on a qkv image, for windows too large for
// a kernel that keeps a whole window in shared memory:
//
//   per ws x ws window of qkv (B, H, W, 3C), q = channels [0, C),
//   k = [C, 2C), v = [2C, 3C), heads as channel slices of d = C / heads:
//     o_h = softmax(q_h k_h^T * scale + bias_h) v_h,  bias (heads, N, N)
//   out (B, H, W, C) in image layout, before the output projection.
//
// Replaces the TPU kernels of super_resolution_tpu/ops/pallas_attention.py:
// msa_qtile_attention (pallas_call at :1902, kernel :1797-1814) and
// msa_flash_attention (:2124, kernel :1998-2031). Both read q, k and v
// straight from the image by index (pixel * 3C + part * C + h * d + t) and
// write the image layout: the per-head planes and the transposed output
// that the TPU versions build in device memory do not exist here.
//
// In bf16 both run on the tensor-core tile of mma_attention.cuh (which says
// what bounds it and how), with the rows of q, k and v gathered from the qkv
// image by pixel index (32 bytes a token at d 16, 16-byte cp.async) and the
// output written to the image layout; a block per (kWindowGroup = 2
// windows, 64 query rows, head), windows fastest:
//
// msa_flash_attention is mma_flash_attention_kernel, an online softmax over
// 64-key chunks whose bias tile the group's windows share.
//
// msa_qtile_attention is mma_qtile_attention_kernel. It keeps the qtile's
// identity, an exact row softmax with p normalised before it is rounded
// (the TPU kernel's cast points), so the whole row's maximum and sum must
// be known before any P @ V: two passes over the key chunks. Pass 1 stages
// the bias tile and k only, forms S = Q K^T on mma.sync, scale and bias in
// float32, and keeps each row's running maximum m and denominator l (only
// l is rescaled; there is no accumulator and v is not read). Pass 2 stages
// bias, k and v, forms S again, p = ex2(s log2 e - m log2 e) / l in float32,
// rounds p to bf16 into A fragments and accumulates P V; the output is
// rounded once, with no division. The first chunk of pass 2 is in flight
// while pass 1 ends. What bounds it on the H100 at ESC-XL's chunk (36
// windows, 12 heads, N 2304, d 16): the function's 2.29 G exponentials take
// 0.588 ms on the special-function units, and this design computes each
// twice, 1.176 ms; its float32 bias stream through the L2 is twice
// msa_flash_attention's: 18 window groups x 2 passes x 255 MB = 9.2 GB.
// The products, S being formed in both passes, are 1.5 times the
// function's 147 GFLOP: 0.22 ms on the tensor cores, below both. So it is
// expected at about twice msa_flash_attention's time; it is kept as the
// exact-softmax A/B partner of msa_flash_attention.
//
// In float32 both are the FMA kernels below, the exact check of the
// algorithm on the card; their entries refuse bf16. What bounds them on the
// H100: per (window, head) at ESC-XL's shape (N 2304, d 16) the two
// products are 4 * 2304 * 2304 * 16 = 340 MFLOP against 295 kB of bf16 q,
// k, v and out, and a 21 MB float32 bias slice a head (255 MB for 12 heads)
// that every window shares. A chunk of four 144 x 144 tiles has 36
// windows: 147 GFLOP against 0.27 GB read once, compute-bound on the tensor
// cores' scale, and bound by the CUDA cores here, whose products are
// float32 FMA loops.
//
// The grid of both FMA kernels is (windows of all images, query tiles,
// heads), windows fastest: the blocks that run together are the same rows
// of one head's bias for different windows, so each bias row comes from
// device memory once and from the 50 MB L2 for the other windows (32 rows
// are 295 kB, the 36 windows of a chunk read it 36 times). k and v are
// re-read by every query tile of their window: 147 kB in bf16, 72 tiles of
// 32 rows (flash) or 144 of 16 (q-tile) a (window, head), 4.6 GB or 9.2 GB
// a call, which the L2 serves as well, the tiles of a window being 36
// blocks apart.
//
// Design, msa_flash_attention (float32): one block per (window, head, 32 query
// rows) loops over chunks of 256 keys: k and v of the chunk go to shared
// memory, the 32 x 256 scores are formed there, and the running maximum, the
// denominator (in shared memory, a float a row) and the accumulator (in
// registers, spread over the block as attention_tiles.cuh describes) are
// updated. The TPU version carries these across a sequential grid axis and runs
// transposed for its lanes; here nothing is carried between blocks. As there, p
// = exp(s - m) is rounded to the input dtype before P @ V, the denominator sums
// the unrounded p, and the output is acc / l, rounded once. 85 kB a block at d
// 16: two blocks an SM.
//
// Design, msa_qtile_attention (float32): exact softmax over whole rows. A block owns
// 16 query rows of one (window, head) and keeps their 16 x N float32 scores
// in shared memory (148 kB at N 2304). k and v are streamed through one
// 256-key buffer in two passes: k chunks fill the scores, the rows are
// normalised (p rounded to the input dtype), then v chunks accumulate the
// output. One head's k and v at N 2304 would take 295 kB as float32, so
// they are not kept. 173 kB a block at N 2304, d 16: one block an SM.
#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kKC = 256;       // keys of a chunk
constexpr int kFlashQT = 32;   // query rows of a flash block
constexpr int kQtileQT = 16;   // query rows of a q-tile block

using srk::Window;
using srk::window_of;

size_t flash_smem_bytes(int dp) {
  return sizeof(float) * (2 * kKC * dp + kFlashQT * srk::score_stride(kKC) +
                          kFlashQT * dp + srk::kTileWarps * kFlashQT * dp +
                          3 * kFlashQT);
}

size_t qtile_smem_bytes(int n, int dp) {
  return sizeof(float) * (kKC * dp + kQtileQT * srk::score_stride(n) +
                          kQtileQT * dp + srk::kTileWarps * kQtileQT * dp);
}

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    msa_flash_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     T* __restrict__ out, int H, int W, int C, int heads,
                     int ws, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QT = kFlashQT;
  constexpr int ld = kKC + 4;
  const int n = ws * ws;
  const int d = C / heads;
  const int h = blockIdx.z;
  const int q0 = blockIdx.y * QT;
  const int qt = min(QT, n - q0);
  const Window win = window_of(blockIdx.x, H, W, ws);

  float* ks = smem;                       // kKC x DP
  float* vs = ks + kKC * DP;              // kKC x DP
  float* sc = vs + kKC * DP;              // QT x ld
  float* qs = sc + QT * ld;               // QT x DP
  float* red = qs + QT * DP;              // warps x QT x DP
  float* m_run = red + srk::kTileWarps * QT * DP;  // QT running maxima
  float* l_run = m_run + QT;                       // QT denominators
  float* alpha = l_run + QT;                       // QT rescale factors

  auto channel = [&](int tok, int part) {
    return qkv + win.pixel(tok) * 3 * C + part * C + h * d;
  };
  srk::load_rows<T, DP>(qs, qt, QT, d,
                        [&](int i) { return channel(q0 + i, 0); });
  for (int i = threadIdx.x; i < QT; i += blockDim.x) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[QT / 4][DP / 8];
  srk::zero_acc<DP, QT>(acc);
  const float* bh = bias + (static_cast<long long>(h) * n + q0) * n;
  const int lane = threadIdx.x & 31;
  const int ri = lane >> 3;

  for (int c0 = 0; c0 < n; c0 += kKC) {
    const int kc = min(kKC, n - c0);
    const int kc4 = srk::round_up4(kc);
    srk::load_rows<T, DP>(ks, kc, kc, d,
                          [&](int j) { return channel(c0 + j, 1); });
    srk::load_rows<T, DP>(vs, kc, kc4, d,
                          [&](int j) { return channel(c0 + j, 2); });
    __syncthreads();
    srk::score_chunk<DP>(qs, qt, ks, kc, sc, ld, 0, scale, [&](int i, int j) {
      return bh[static_cast<long long>(i) * n + c0 + j];
    });
    __syncthreads();
    // online softmax, one warp per row: new maximum, rescale factor of what
    // was accumulated so far, p of this chunk, denominator
    for (int r = threadIdx.x >> 5; r < qt; r += srk::kTileWarps) {
      float* row = sc + r * ld;
      const float m_old = m_run[r];
      float mx = -INFINITY;
      for (int j = lane; j < kc; j += 32) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_old, srk::warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < kc; j += 32) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = srk::round_to<T>(p);
      }
      for (int j = kc + lane; j < kc4; j += 32) row[j] = 0.f;
      sum = srk::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first chunk
        alpha[r] = a;
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QT / 4; ++r) {
      const float a = (ri + 4 * r < qt) ? alpha[ri + 4 * r] : 0.f;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) acc[r][c] *= a;
    }
    srk::pv_chunk<DP, QT>(sc, ld, 0, vs, kc4, acc);
    __syncthreads();
  }
  srk::pv_reduce<DP, QT>(acc, red, qt, d, [&](int i, int t, float o) {
    out[win.pixel(q0 + i) * C + h * d + t] = srk::from_f<T>(o / l_run[i]);
  });
}

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    msa_qtile_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     T* __restrict__ out, int H, int W, int C, int heads,
                     int ws, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QT = kQtileQT;
  const int n = ws * ws;
  const int ld = srk::score_stride(n);
  const int d = C / heads;
  const int h = blockIdx.z;
  const int q0 = blockIdx.y * QT;
  const int qt = min(QT, n - q0);
  const Window win = window_of(blockIdx.x, H, W, ws);

  float* kv = smem;                       // kKC x DP: a k chunk, then a v chunk
  float* sc = kv + kKC * DP;              // QT x ld
  float* qs = sc + QT * ld;               // QT x DP
  float* red = qs + QT * DP;              // warps x QT x DP

  auto channel = [&](int tok, int part) {
    return qkv + win.pixel(tok) * 3 * C + part * C + h * d;
  };
  srk::load_rows<T, DP>(qs, qt, QT, d,
                        [&](int i) { return channel(q0 + i, 0); });
  const float* bh = bias + (static_cast<long long>(h) * n + q0) * n;
  for (int c0 = 0; c0 < n; c0 += kKC) {
    const int kc = min(kKC, n - c0);
    srk::load_rows<T, DP>(kv, kc, kc, d,
                          [&](int j) { return channel(c0 + j, 1); });
    __syncthreads();
    srk::score_chunk<DP>(qs, qt, kv, kc, sc, ld, c0, scale, [&](int i, int j) {
      return bh[static_cast<long long>(i) * n + j];
    });
    __syncthreads();
  }
  srk::softmax_tile<T>(sc, qt, n, ld);
  float acc[QT / 4][DP / 8];
  srk::zero_acc<DP, QT>(acc);
  for (int c0 = 0; c0 < n; c0 += kKC) {
    const int kc = min(kKC, n - c0);
    const int kc4 = srk::round_up4(kc);
    srk::load_rows<T, DP>(kv, kc, kc4, d,
                          [&](int j) { return channel(c0 + j, 2); });
    __syncthreads();  // the first one also ends the softmax
    srk::pv_chunk<DP, QT>(sc, ld, c0, kv, kc4, acc);
    __syncthreads();
  }
  srk::pv_reduce<DP, QT>(acc, red, qt, d, [&](int i, int t, float o) {
    out[win.pixel(q0 + i) * C + h * d + t] = srk::from_f<T>(o);
  });
}

template <typename T, int DP>
cudaError_t launch(bool flash, const void* qkv, const float* bias, void* out,
                   int B, int H, int W, int C, int heads, int ws, float scale,
                   cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;  // bf16: the sr_mma_* entries
  } else {
    const int n = ws * ws;
    const int windows = B * (H / ws) * (W / ws);
    const T* in = static_cast<const T*>(qkv);
    T* ot = static_cast<T*>(out);
    cudaError_t err;
    if (flash) {
      const size_t smem = flash_smem_bytes(DP);
      err = srk::set_smem(msa_flash_kernel<T, DP>, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(windows, (n + kFlashQT - 1) / kFlashQT, heads);
      msa_flash_kernel<T, DP><<<grid, srk::kTileThreads, smem, stream>>>(
          in, bias, ot, H, W, C, heads, ws, scale);
    } else {
      const size_t smem = qtile_smem_bytes(n, DP);
      err = srk::set_smem(msa_qtile_kernel<T, DP>, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(windows, (n + kQtileQT - 1) / kQtileQT, heads);
      msa_qtile_kernel<T, DP><<<grid, srk::kTileThreads, smem, stream>>>(
          in, bias, ot, H, W, C, heads, ws, scale);
    }
    return cudaGetLastError();
  }
}

int dispatch(bool flash, int dtype, const void* qkv, const void* bias,
             void* out, int B, int H, int W, int C, int heads, int ws,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (heads < 1 || heads > 65535 || C % heads || ws < 1 || H % ws || W % ws ||
      B < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const int d = C / heads;
  const int tiles = (ws * ws + kQtileQT - 1) / kQtileQT;
  if (d > 32 || tiles > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return d <= 16 ? launch<float, 16>(flash, qkv, bf, out, B, H, W, C, heads,
                                       ws, scale, st)
                   : launch<float, 32>(flash, qkv, bf, out, B, H, W, C, heads,
                                       ws, scale, st);
  return d <= 16 ? launch<__nv_bfloat16, 16>(flash, qkv, bf, out, B, H, W, C,
                                             heads, ws, scale, st)
                 : launch<__nv_bfloat16, 32>(flash, qkv, bf, out, B, H, W, C,
                                             heads, ws, scale, st);
}

// Windows of a qkv image as rows of the tensor-core tile
// (mma_attention.cuh): q, k, v are channel slices of a pixel's 3C values.
struct ImageRows {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  int H, W, C, heads, ws, d;
  struct Win {
    Window w;
    int hd;  // the head's first channel
  };
  __device__ __forceinline__ Win win(int widx, int h) const {
    return Win{window_of(widx, H, W, ws), h * d};
  }
  __device__ __forceinline__ const __nv_bfloat16* row(const Win& w, int part,
                                                      int i) const {
    return qkv + w.w.pixel(i) * 3 * C + part * C + w.hd;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(const Win& w,
                                                    int i) const {
    return out + w.w.pixel(i) * C + w.hd;
  }
};

template <int DP>
__global__ void __launch_bounds__(srk::mma::kThreads)
    mma_flash_attention_kernel(ImageRows rows, const float* __restrict__ bias,
                               int windows, int n, float scale, int vec_kv,
                               int vec_bias) {
  srk::mma::attention_block<DP>(rows, bias, windows, n, n, rows.d, scale,
                                vec_kv != 0, vec_bias != 0);
}

template <int DP>
__global__ void __launch_bounds__(srk::mma::kThreads)
    mma_qtile_attention_kernel(ImageRows rows, const float* __restrict__ bias,
                               int windows, int n, float scale, int vec_kv,
                               int vec_bias) {
  srk::mma::exact_attention_block<DP>(rows, bias, windows, n, n, rows.d,
                                      scale, vec_kv != 0, vec_bias != 0);
}

template <int DP>
cudaError_t launch_mma(bool qtile, const ImageRows& rows, const float* bias,
                       int windows, float scale, bool vec_kv, bool vec_bias,
                       cudaStream_t stream) {
  constexpr int G = srk::mma::kWindowGroup;
  const int smem = srk::mma::smem_bytes(DP);
  auto kernel = qtile ? mma_qtile_attention_kernel<DP>
                      : mma_flash_attention_kernel<DP>;
  cudaError_t err = srk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n = rows.ws * rows.ws;
  const dim3 grid((windows + G - 1) / G,
                  (n + srk::mma::kQRows - 1) / srk::mma::kQRows, rows.heads);
  kernel<<<grid, srk::mma::kThreads, smem, stream>>>(rows, bias, windows, n,
                                                     scale, vec_kv, vec_bias);
  return cudaGetLastError();
}

int dispatch_mma(bool qtile, const void* qkv, const void* bias, void* out,
                 int B, int H, int W, int C, int heads, int ws, float scale,
                 void* stream) {
  if (heads < 1 || heads > 65535 || C % heads || ws < 1 || H % ws || W % ws ||
      B < 1)
    return cudaErrorInvalidValue;
  const int d = C / heads, n = ws * ws;
  if (d > 32 || (n + srk::mma::kQRows - 1) / srk::mma::kQRows > 65535)
    return cudaErrorInvalidValue;
  const int dp = d <= 16 ? 16 : 32;
  const int windows = B * (H / ws) * (W / ws);
  const ImageRows rows{static_cast<const __nv_bfloat16*>(qkv),
                       static_cast<__nv_bfloat16*>(out), H, W, C, heads, ws,
                       d};
  // a row starts at pixel * 3C + part * C + h * d values: 16-byte aligned
  // for every pixel, part and head where C and d are multiples of 8
  const bool vec_kv = d == dp && C % 8 == 0 && srk::mma::aligned16(qkv);
  const bool vec_bias = n % 4 == 0 && srk::mma::aligned16(bias);
  const float* bf32 = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dp == 16 ? launch_mma<16>(qtile, rows, bf32, windows, scale, vec_kv,
                                   vec_bias, st)
                  : launch_mma<32>(qtile, rows, bf32, windows, scale, vec_kv,
                                   vec_bias, st);
}

}  // namespace

// msa_flash_attention (sr_mma_flash_attention) and msa_qtile_attention
// (sr_mma_qtile_attention) in bf16 on the tensor cores: qkv (B, H, W, 3C),
// out (B, H, W, C) bf16, bias (heads, ws^2, ws^2) float32; the shared
// memory is sr_mma_attention_smem's. Return the cudaError_t of the launch.
extern "C" int sr_mma_flash_attention(const void* qkv, const void* bias,
                                      void* out, int B, int H, int W, int C,
                                      int heads, int ws, float scale,
                                      void* stream) {
  return dispatch_mma(false, qkv, bias, out, B, H, W, C, heads, ws, scale,
                      stream);
}

extern "C" int sr_mma_qtile_attention(const void* qkv, const void* bias,
                                      void* out, int B, int H, int W, int C,
                                      int heads, int ws, float scale,
                                      void* stream) {
  return dispatch_mma(true, qkv, bias, out, B, H, W, C, heads, ws, scale,
                      stream);
}

// Bytes of dynamic shared memory a block of the FMA kernels needs; the
// wrappers hold these against the card's limit.
extern "C" int sr_msa_flash_smem(int d) {
  return static_cast<int>(flash_smem_bytes(d <= 16 ? 16 : 32));
}

extern "C" int sr_msa_qtile_smem(int ws, int d) {
  return static_cast<int>(qtile_smem_bytes(ws * ws, d <= 16 ? 16 : 32));
}

// The FMA kernels. dtype: 0 float32; 1 (bf16) is refused, bf16 is the
// sr_mma_* entries'. qkv (B, H, W, 3C), out (B, H, W, C), bias
// (heads, ws^2, ws^2) float32. Returns the cudaError_t of the launch.
extern "C" int sr_msa_flash_attention(int dtype, const void* qkv,
                                      const void* bias, void* out, int B,
                                      int H, int W, int C, int heads, int ws,
                                      float scale, void* stream) {
  return dispatch(true, dtype, qkv, bias, out, B, H, W, C, heads, ws, scale,
                  stream);
}

extern "C" int sr_msa_qtile_attention(int dtype, const void* qkv,
                                      const void* bias, void* out, int B,
                                      int H, int W, int C, int heads, int ws,
                                      float scale, void* stream) {
  return dispatch(false, dtype, qkv, bias, out, B, H, W, C, heads, ws, scale,
                  stream);
}
