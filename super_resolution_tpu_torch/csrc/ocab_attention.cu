// The attention middle of a fork-HAT OCAB on projected images, NHWC:
//
//   per ws x ws window of q_img (B, H, W, c) and the ow x ow window of
//   kv_img (B, H, W, 2c) around it (k = channels [0, c), v = [c, 2c)),
//   zero outside the image:
//     o_h = softmax(q_h k_h^T * scale + RPB_h) v_h   for each head
//   out (B, H, W, c) in image layout, heads as channel slices.
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_attention.py:
// fused_ocab_attention (pallas_call at :296, body _ocab_kernel :208-231).
// The ESC-infused OCAB calls it: its k and v come from another feature
// image than its q, so the projections are made outside and only the
// windowed attention is fused. The TPU version pads the kv image by
// (ow - ws) / 2 first; here no padded copy exists: a key outside the image
// reads a row of zeros, and still takes part in the softmax (score = bias
// alone), as in the reference.
//
// What bounds it on the H100: at the fork HAT's chunk (four 160 x 160
// tiles: 400 windows of N 256 against Nk 576, 6 heads of d 30) the two
// products are 4 * 400 * 6 * 256 * 576 * 30 = 42 GFLOP (0.043 ms on the
// tensor cores, d padded to 32) against 354 M exponentials (0.091 ms on
// the special-function units) and 151 MB of bf16 images and the 3.5 MB
// float32 bias read once (0.045 ms at the HBM rate). So, as for
// fused_attention, the exp unit and the bias stream through the L2 set the
// pace.
//
// In bf16 it is mma_ocab_attention_kernel: the tensor-core tile of
// mma_attention.cuh (attention_block: a block per (kWindowGroup = 2
// windows, 64 query rows, head), windows fastest, online softmax over
// 64-key chunks, each bias tile shared by the group's windows) with the
// rows given by OcabRows: part 0 is a q pixel's head slice, parts 1 and 2
// the k and v slices of an overlap-window pixel, and a key outside the
// image gets kZeroRow. 576 = 9 x 64 keys, so no chunk is ragged at the
// flagship shape. Head slices start every 60 bytes of a 720-byte kv pixel
// row: no 16-byte copies, so OcabRows asks for 4-byte ones
// (kWordCopies), 15 words a head row and its two pad columns zeroed; an
// odd head dim takes the tile's plain element copies. Keys of the overlap
// window are found with one multiply-high (ow_magic), not a division. The
// cast points are the online softmax's: p = exp(s - m) is rounded to bf16
// unnormalised and the output divided by the float32 denominator, where the
// TPU kernel normalises p before its cast (:222-229).
//
// In float32 it is the FMA kernel below, the exact check of the algorithm
// on the card; its entry refuses bf16. Design: one block per window, a loop
// over heads. Per head q (N x d), k and v (Nk x d) are loaded into shared
// memory as float32 and go through the same one-head loop as the OCAB block
// kernel (common.cuh: attend_head), which writes the output straight to
// the image. Shared memory per block at the flagship shape: 187 kB.
#include <stdint.h>

#include "attention_tiles.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQChunk = 8;
constexpr int kMaxD = 32;

__global__ void __launch_bounds__(kThreads)
    ocab_attention_kernel(const float* __restrict__ q_img,
                          const float* __restrict__ kv_img,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int H, int W, int c,
                          int heads, int ws, int ow, float scale) {
  extern __shared__ float smem[];
  const int n = ws * ws, nk = ow * ow;
  const int d = c / heads;
  const int pad = (ow - ws) / 2;
  const int nwx = W / ws;
  const int wid = blockIdx.x;
  const int b = blockIdx.y;
  const int wy = wid / nwx, wx = wid % nwx;

  float* q = smem;                 // n x d
  float* k = q + n * d;            // nk x d
  float* v = k + nk * d;           // nk x d
  float* sc = v + nk * d;          // kQChunk x nk
  int* kpix = reinterpret_cast<int*>(sc + kQChunk * nk);  // nk, -1 outside
  int* qpix = kpix + nk;                                  // n

  for (int t = threadIdx.x; t < nk; t += blockDim.x) {
    const int ky = wy * ws - pad + t / ow, kx = wx * ws - pad + t % ow;
    kpix[t] = (ky >= 0 && ky < H && kx >= 0 && kx < W)
                  ? (b * H + ky) * W + kx
                  : -1;
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    qpix[t] = (b * H + wy * ws + t / ws) * W + wx * ws + t % ws;
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
      const int m = e / d, j = e % d;
      q[e] = q_img[static_cast<long long>(qpix[m]) * c + h * d + j];
    }
    for (int e = threadIdx.x; e < nk * d; e += blockDim.x) {
      const int m = e / d, j = e % d;
      float kk = 0.f, vv = 0.f;
      if (kpix[m] >= 0) {
        const float* row = kv_img + static_cast<long long>(kpix[m]) * 2 * c;
        kk = row[h * d + j];
        vv = row[c + h * d + j];
      }
      k[e] = kk;
      v[e] = vv;
    }
    __syncthreads();

    const float* bh = bias + static_cast<long long>(h) * n * nk;
    srk::attend_head<float, kQChunk, kMaxD>(
        q, k, v, sc, n, nk, d, scale,
        [&](int i, int j) { return bh[static_cast<long long>(i) * nk + j]; },
        [&](int i, int t, float o) {
          out[static_cast<long long>(qpix[i]) * c + h * d + t] = o;
        });
  }
}

size_t smem_bytes(int c, int heads, int ws, int ow) {
  const int n = ws * ws, nk = ow * ow;
  const int d = c / heads;
  return sizeof(float) * (n * d + 2 * nk * d + kQChunk * nk) +
         sizeof(int) * (nk + n);
}

cudaError_t launch(const float* q_img, const float* kv_img,
                   const float* bias, float* out, int B, int H, int W, int c,
                   int heads, int ws, int ow, float scale,
                   cudaStream_t stream) {
  const int d = c / heads;
  if (d > kMaxD || d * heads != c || H % ws || W % ws || ow < ws ||
      (ow - ws) % 2)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c, heads, ws, ow);
  cudaError_t err = srk::set_smem(ocab_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  ocab_attention_kernel<<<grid, kThreads, smem, stream>>>(
      q_img, kv_img, bias, out, H, W, c, heads, ws, ow, scale);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// The k or v row of a key outside the image: zeros, head dims up to 32.
__device__ __align__(16) uint32_t kZeroRow[16];

// The windows of a q image and the overlap windows of a kv image as rows of
// the tensor-core tile (mma_attention.cuh).
struct OcabRows {
  static constexpr bool kWordCopies = true;
  const bf16* q;
  const bf16* kv;
  bf16* out;
  int H, W, C, ws, ow, d;
  unsigned ow_magic;  // floor((2^32 - 1) / ow) + 1: i / ow = umulhi(i, it)
  struct Win {
    long long first;  // pixel of the q window's first token
    int y0, x0;       // image row and column of the overlap window's corner
    int row0, hd;     // image row of the window's batch; the head's channel
  };
  __device__ __forceinline__ Win win(int widx, int h) const {
    const int nwx = W / ws, nw = (H / ws) * nwx;
    const int b = widx / nw, wi = widx % nw;
    const int pad = (ow - ws) / 2;
    const int y = (wi / nwx) * ws, x = (wi % nwx) * ws;
    return Win{(static_cast<long long>(b) * H + y) * W + x, y - pad, x - pad,
               b * H, h * d};
  }
  __device__ __forceinline__ long long q_pixel(const Win& w, int i) const {
    return w.first + static_cast<long long>(i / ws) * W + i % ws;
  }
  __device__ __forceinline__ const bf16* row(const Win& w, int part,
                                             int i) const {
    if (part == 0) return q + q_pixel(w, i) * C + w.hd;
    const int ky = __umulhi(static_cast<unsigned>(i), ow_magic);
    const int y = w.y0 + ky, x = w.x0 + i - ky * ow;
    if (y < 0 || y >= H || x < 0 || x >= W)
      return reinterpret_cast<const bf16*>(kZeroRow);
    return kv + ((static_cast<long long>(w.row0) + y) * W + x) * 2 * C +
           (part - 1) * C + w.hd;
  }
  __device__ __forceinline__ bf16* out_row(const Win& w, int i) const {
    return out + q_pixel(w, i) * C + w.hd;
  }
};

template <int DP>
__global__ void __launch_bounds__(srk::mma::kThreads)
    mma_ocab_attention_kernel(OcabRows rows, const float* __restrict__ bias,
                              int windows, float scale, int vec_kv,
                              int vec_bias) {
  srk::mma::attention_block<DP>(rows, bias, windows, rows.ws * rows.ws,
                                rows.ow * rows.ow, rows.d, scale, vec_kv != 0,
                                vec_bias != 0);
}

template <int DP>
cudaError_t launch_mma(const OcabRows& rows, const float* bias, int windows,
                       int heads, float scale, bool vec_kv, bool vec_bias,
                       cudaStream_t stream) {
  constexpr int G = srk::mma::kWindowGroup;
  const int smem = srk::mma::smem_bytes(DP);
  cudaError_t err = srk::set_smem(mma_ocab_attention_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const int n = rows.ws * rows.ws;
  const dim3 grid((windows + G - 1) / G,
                  (n + srk::mma::kQRows - 1) / srk::mma::kQRows, heads);
  mma_ocab_attention_kernel<DP><<<grid, srk::mma::kThreads, smem, stream>>>(
      rows, bias, windows, scale, vec_kv, vec_bias);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block of the FMA kernel needs; the
// wrapper holds this against the card's limit before it launches.
extern "C" int sr_ocab_attention_smem(int c, int heads, int ws, int ow) {
  return static_cast<int>(smem_bytes(c, heads, ws, ow));
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_ocab_attention's. bias (heads, ws^2, ow^2) is float32. Returns the
// cudaError_t of the launch.
extern "C" int sr_ocab_attention(int dtype, const void* q_img,
                                 const void* kv_img, const void* bias,
                                 void* out, int B, int H, int W, int c,
                                 int heads, int ws, int ow, float scale,
                                 void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch(static_cast<const float*>(q_img),
                static_cast<const float*>(kv_img),
                static_cast<const float*>(bias), static_cast<float*>(out), B,
                H, W, c, heads, ws, ow, scale,
                static_cast<cudaStream_t>(stream));
}

// fused_ocab_attention in bf16 on the tensor cores: q_img, out (B, H, W, c),
// kv_img (B, H, W, 2c) bf16, bias (heads, ws^2, ow^2) float32; head dims up
// to 32, H and W multiples of ws, an even overlap. The shared memory is
// sr_mma_attention_smem's. Returns the cudaError_t of the launch.
extern "C" int sr_mma_ocab_attention(const void* q_img, const void* kv_img,
                                     const void* bias, void* out, int B,
                                     int H, int W, int c, int heads, int ws,
                                     int ow, float scale, void* stream) {
  if (heads < 1 || heads > 65535 || c % heads || ws < 1 || H % ws ||
      W % ws || B < 1 || ow < ws || ow > 1024 || (ow - ws) % 2)
    return cudaErrorInvalidValue;
  const int d = c / heads, n = ws * ws;
  if (d > 32 || (n + srk::mma::kQRows - 1) / srk::mma::kQRows > 65535)
    return cudaErrorInvalidValue;
  const int dp = d <= 16 ? 16 : 32;
  const int windows = B * (H / ws) * (W / ws);
  const OcabRows rows{static_cast<const bf16*>(q_img),
                      static_cast<const bf16*>(kv_img),
                      static_cast<bf16*>(out),
                      H,
                      W,
                      c,
                      ws,
                      ow,
                      d,
                      0xffffffffu / static_cast<unsigned>(ow) + 1u};
  // a k or v row starts at pixel * 2c + part * c + h * d values: 4-byte
  // aligned for every pixel, part and head where d is even
  const bool vec_kv =
      d % 2 == 0 && (reinterpret_cast<uintptr_t>(kv_img) & 3u) == 0;
  const bool vec_bias = (ow * ow) % 4 == 0 && srk::mma::aligned16(bias);
  const float* bf32 = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dp == 16 ? launch_mma<16>(rows, bf32, windows, heads, scale, vec_kv,
                                   vec_bias, st)
                  : launch_mma<32>(rows, bf32, windows, heads, scale, vec_kv,
                                   vec_bias, st);
}
