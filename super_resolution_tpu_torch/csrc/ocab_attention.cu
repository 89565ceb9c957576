// The attention middle of a fork-HAT OCAB on projected images, NHWC:
//
//   per ws x ws window of q_img (B, H, W, c) and the ow x ow window of
//   kv_img (B, H, W, 2c) around it (k = channels [0, c), v = [c, 2c)),
//   zero outside the image:
//     o_h = softmax(q_h k_h^T * scale + RPB_h) v_h   for each head
//   out (B, H, W, c) in image layout, heads as channel slices.
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_attention.py:
// fused_ocab_attention (pallas_call at :296). The ESC-infused OCAB calls it:
// its k and v come from another feature image than its q, so the
// projections are made outside and only the windowed attention is fused.
// The TPU version pads the kv image by (ow - ws) / 2 first; here the loader
// tests the pixel index and puts zeros for keys outside the image, so no
// padded copy exists. Those zero keys still take part in the softmax (score
// = bias alone), as in the reference.
//
// What bounds it on the H100: per window at the flagship shape (N 256,
// Nk 576, 6 heads of 30) attention is 4 * 6 * 256 * 576 * 30 = 106 MFLOP
// against 256 * 180 * 2 * 2 + 576 * 360 * 2 = 0.6 MB of bf16 window reads:
// compute-bound. This first version runs both products as float32 FMA
// loops on the CUDA cores and is bound by them.
//
// Design: one block per window, a loop over heads. Per head q (N x d), k
// and v (Nk x d) are loaded into shared memory as float32 and go through
// the same one-head loop as the OCAB block kernel (common.cuh:
// attend_head), which writes the output straight to the image. Shared
// memory per block at the flagship shape: 187 kB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQChunk = 8;
constexpr int kMaxD = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ocab_attention_kernel(const T* __restrict__ q_img,
                          const T* __restrict__ kv_img,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int H, int W, int c, int heads, int ws, int ow,
                          float scale) {
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
      q[e] = srk::to_f(q_img[static_cast<long long>(qpix[m]) * c + h * d + j]);
    }
    for (int e = threadIdx.x; e < nk * d; e += blockDim.x) {
      const int m = e / d, j = e % d;
      float kk = 0.f, vv = 0.f;
      if (kpix[m] >= 0) {
        const T* row = kv_img + static_cast<long long>(kpix[m]) * 2 * c;
        kk = srk::to_f(row[h * d + j]);
        vv = srk::to_f(row[c + h * d + j]);
      }
      k[e] = kk;
      v[e] = vv;
    }
    __syncthreads();

    const float* bh = bias + static_cast<long long>(h) * n * nk;
    srk::attend_head<T, kQChunk, kMaxD>(
        q, k, v, sc, n, nk, d, scale,
        [&](int i, int j) { return bh[static_cast<long long>(i) * nk + j]; },
        [&](int i, int t, float o) {
          out[static_cast<long long>(qpix[i]) * c + h * d + t] =
              srk::from_f<T>(o);
        });
  }
}

size_t smem_bytes(int c, int heads, int ws, int ow) {
  const int n = ws * ws, nk = ow * ow;
  const int d = c / heads;
  return sizeof(float) * (n * d + 2 * nk * d + kQChunk * nk) +
         sizeof(int) * (nk + n);
}

template <typename T>
cudaError_t launch(const void* q_img, const void* kv_img, const float* bias,
                   void* out, int B, int H, int W, int c, int heads, int ws,
                   int ow, float scale, cudaStream_t stream) {
  const int d = c / heads;
  if (d > kMaxD || d * heads != c || H % ws || W % ws || ow < ws ||
      (ow - ws) % 2)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c, heads, ws, ow);
  cudaError_t err = srk::set_smem(ocab_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  ocab_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_img), static_cast<const T*>(kv_img), bias,
      static_cast<T*>(out), H, W, c, heads, ws, ow, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_ocab_attention_smem(int c, int heads, int ws, int ow) {
  return static_cast<int>(smem_bytes(c, heads, ws, ow));
}

// dtype: 0 float32, 1 bfloat16. bias (heads, ws^2, ow^2) is float32.
// Returns the cudaError_t of the launch.
extern "C" int sr_ocab_attention(int dtype, const void* q_img,
                                 const void* kv_img, const void* bias,
                                 void* out, int B, int H, int W, int c,
                                 int heads, int ws, int ow, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<float>(q_img, kv_img, bf, out, B, H, W, c, heads, ws, ow,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_img, kv_img, bf, out, B, H, W, c, heads,
                                 ws, ow, scale, st);
  return cudaErrorInvalidValue;
}
