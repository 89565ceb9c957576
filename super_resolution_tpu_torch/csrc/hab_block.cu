// The whole unshifted classic HAT block after norm1 and the CAB, NHWC:
//
//   per ws x ws window:
//     attn = concat_h(softmax(q_h k_h^T * scale + RPB_h) v_h) @ Wproj + b,
//            qkv = ln_x @ Wqkv + b              (rounded to T)
//     x    = shortcut + attn + cs * conv_x      (float32)
//     out  = x + fc2(gelu(fc1(LN2(x))))
//
// Replaces the TPU kernel of super_resolution_tpu/ops/pallas_attention.py:
// fused_hab_block (pallas_call at :1707, body _hab_block_kernel). As there,
// attn stays float32 into the 3-way sum; the plain version rounds it to T
// first, as the JAX reference does.
//
// What bounds it on the H100: the work of msa_block.cu and mlp_tail.cu
// together (per window at the flagship shape 113 MFLOP of attention and
// projections and 66 MFLOP of MLP) less one write and one read of the
// attention image; like them it runs its products as float32 FMA loops on
// the CUDA cores and is bound by those.
//
// Design: one block per window, the two halves of block_parts.cuh in turn.
// The attention runs as in msa_block.cu (per head q, k, v and 16 score rows
// in shared memory, the head concat in a wrapper-allocated scratch image).
// A 256 x 180 float32 tile of attn does not fit beside either half, so the
// block then walks its window's tokens 32 at a time: output projection of
// the 32 rows, the 3-way sum with x and conv_x read at the window's pixels,
// then LN2, fc1, GELU, fc2 and the residual as in mlp_tail.cu, in the
// shared memory the attention no longer needs. At the flagship shape: 110
// kB a block, two blocks an SM.
#include "block_parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = srk::kTailRows;

__host__ __device__ inline size_t work_floats(int n, int d, int C, int hid) {
  const size_t a = srk::msa_heads_floats(n, d);
  const size_t t = srk::mlp_tail_floats(C, hid);
  return a > t ? a : t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hab_block_kernel(const T* __restrict__ lnx, const T* __restrict__ x,
                     const T* __restrict__ cv, const T* __restrict__ wqkv,
                     const T* __restrict__ bqkv, const T* __restrict__ wproj,
                     const T* __restrict__ bproj,
                     const float* __restrict__ bias,
                     const T* __restrict__ gamma, const T* __restrict__ beta,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     T* o_scr, T* __restrict__ out, int H, int W, int C,
                     int hid, int heads, int ws, float scale, float cs,
                     float eps) {
  extern __shared__ float smem[];
  const int n = ws * ws;
  const int nwx = W / ws;
  const int wy = blockIdx.x / nwx, wx = blockIdx.x % nwx;
  const int b = blockIdx.y;
  int* pix = reinterpret_cast<int*>(smem + work_floats(n, C / heads, C, hid));

  for (int t = threadIdx.x; t < n; t += blockDim.x)
    pix[t] = (b * H + wy * ws + t / ws) * W + wx * ws + t % ws;
  __syncthreads();

  srk::msa_window_heads<T>(lnx, wqkv, bqkv, bias, nullptr, o_scr, pix, pix,
                           smem, n, C, C, heads, scale);

  float* xs = smem;             // kRows x C: the 3-way sum, float32
  float* ys = xs + kRows * C;   // kRows x C
  float* gs = ys + kRows * C;   // kRows x hid
  for (int r0 = 0; r0 < n; r0 += kRows) {
    const int rows = min(kRows, n - r0);
    const int* p = pix + r0;
    srk::block_gemm<4, 4>(
        rows, C, C,
        [&](int m, int k) {
          return srk::to_f(o_scr[static_cast<long long>(p[m]) * C + k]);
        },
        [&](int k, int col) {
          return srk::to_f(wproj[static_cast<long long>(k) * C + col]);
        },
        [&](int m, int col, float acc) {
          const long long e = static_cast<long long>(p[m]) * C + col;
          xs[m * C + col] = srk::to_f(x[e]) + (acc + srk::to_f(bproj[col])) +
                            srk::to_f(cv[e]) * cs;
        });
    __syncthreads();
    srk::mlp_tail_rows<T>(xs, ys, gs, rows, C, hid, gamma, beta, w1, b1, w2,
                          b2, eps, 1.f, [&](int m, int col, float o) {
                            out[static_cast<long long>(p[m]) * C + col] =
                                srk::from_f<T>(o);
                          });
    __syncthreads();
  }
}

size_t smem_bytes(int ws, int C, int heads, int hid) {
  const int n = ws * ws;
  return sizeof(float) * work_floats(n, C / heads, C, hid) + sizeof(int) * n;
}

template <typename T>
cudaError_t launch(const void* lnx, const void* x, const void* cv,
                   const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const float* bias, const void* gamma,
                   const void* beta, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* o_scr, void* out,
                   int B, int H, int W, int C, int hid, int heads, int ws,
                   float scale, float cs, float eps, cudaStream_t stream) {
  if (heads < 1 || C % heads || C / heads > srk::kMsaMaxD || H % ws || W % ws)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ws, C, heads, hid);
  cudaError_t err = srk::set_smem(hab_block_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  hab_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(lnx), static_cast<const T*>(x),
      static_cast<const T*>(cv), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), bias, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(o_scr), static_cast<T*>(out),
      H, W, C, hid, heads, ws, scale, cs, eps);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for window ws, C channels
// in heads heads and an MLP of hid; the wrapper holds this against the
// card's limit before it launches.
extern "C" int sr_hab_block_smem(int ws, int C, int heads, int hid) {
  return static_cast<int>(smem_bytes(ws, C, heads, hid));
}

// dtype: 0 float32, 1 bfloat16. bias (heads, N, N) is float32; o_scr is a
// (B, H, W, C) scratch image of type dtype. Returns the cudaError_t of the
// launch.
extern "C" int sr_hab_block(int dtype, const void* lnx, const void* x,
                            const void* cv, const void* wqkv,
                            const void* bqkv, const void* wproj,
                            const void* bproj, const void* bias,
                            const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* o_scr, void* out, int B,
                            int H, int W, int C, int hid, int heads, int ws,
                            float scale, float cs, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<float>(lnx, x, cv, wqkv, bqkv, wproj, bproj, bf, gamma,
                         beta, w1, b1, w2, b2, o_scr, out, B, H, W, C, hid,
                         heads, ws, scale, cs, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(lnx, x, cv, wqkv, bqkv, wproj, bproj, bf,
                                 gamma, beta, w1, b1, w2, b2, o_scr, out, B,
                                 H, W, C, hid, heads, ws, scale, cs, eps, st);
  return cudaErrorInvalidValue;
}
