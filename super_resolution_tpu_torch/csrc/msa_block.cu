// The (shifted) window self-attention half of a classic HAT block, NHWC,
// with its qkv and output projections:
//
//   per ws x ws window of x (read at ((y + ss) mod H, (x + ss) mod W)):
//     qkv = x @ Wqkv + b                       (rounded to T)
//     o_h = softmax(q_h k_h^T * scale + RPB_h + mask_w) v_h   for each head
//     out = concat_h(o_h) @ Wproj + b           (written in rolled space)
//
// Replaces the TPU kernels of super_resolution_tpu/ops/pallas_attention.py:
// fused_msa_block (pallas_call at :948) and fused_msa_block_shifted
// (:1063). The shift is an argument: with ss > 0 the token loader takes the
// modular index, so the cyclic roll of the input costs nothing and the
// output stays in rolled space, as the TPU kernel leaves it. The
// rolled-space shift mask is read from the (nW, N, N) tensor the caller
// passes ((1, N, N) zeros for unshifted blocks).
//
// What bounds it on the H100: per window at the flagship shape (N 256,
// C 180, 6 heads of 30) the products are 2 * 256 * 180 * 720 = 66 MFLOP
// of projections and 4 * 6 * 256 * 256 * 30 = 47 MFLOP of attention,
// against 2 * 256 * 180 * 2 = 184 kB of bf16 image traffic: about
// 600 FLOP/byte, compute-bound even on the tensor cores. This first version
// runs every product as float32 FMA loops on the CUDA cores and is bound by
// them.
//
// Design: one block per window. Per head, q, k and v (256 x 30 each,
// float32) sit in shared memory; scores are formed for 16 query rows at a
// time (16 x 256 float32; block_parts.cuh::msa_window_heads), so the
// 256 x 256 score matrix never exists whole. The concatenated head outputs go to a wrapper-allocated scratch
// image; after a block barrier the same block applies the output
// projection to its own window. Shared memory per block at the flagship
// shape: 108 kB, two blocks per SM.
#include "block_parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = srk::kMsaMaxD;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    msa_block_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                     const T* __restrict__ bqkv, const T* __restrict__ wproj,
                     const T* __restrict__ bproj,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, int mask_n, T* o_scr,
                     T* __restrict__ out, int H, int W, int cin, int cloc,
                     int cout, int heads, int ws, int ss, float scale) {
  extern __shared__ float smem[];
  const int n = ws * ws;
  const int d = cloc / heads;
  const int nwx = W / ws;
  const int wid = blockIdx.x;  // window index within the image
  const int b = blockIdx.y;
  const int wy = wid / nwx, wx = wid % nwx;

  const size_t work = srk::msa_heads_floats(n, d);  // q, k, v, scores
  int* src = reinterpret_cast<int*>(smem + work);   // n input pixels
  int* dst = src + n;                               // n output pixels

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int ty = wy * ws + t / ws, tx = wx * ws + t % ws;  // rolled space
    dst[t] = (b * H + ty) * W + tx;
    src[t] = (b * H + (ty + ss) % H) * W + (tx + ss) % W;
  }
  __syncthreads();

  const float* mk = mask + static_cast<long long>(wid % mask_n) * n * n;
  srk::msa_window_heads<T>(x, wqkv, bqkv, bias, mk, o_scr, src, dst, smem, n,
                           cin, cloc, heads, scale);

  // output projection of this window's head concat (rounded to T above)
  srk::block_gemm<4, 4>(
      n, cout, cloc,
      [&](int m, int c) {
        return srk::to_f(o_scr[static_cast<long long>(dst[m]) * cloc + c]);
      },
      [&](int c, int col) {
        return srk::to_f(wproj[static_cast<long long>(c) * cout + col]);
      },
      [&](int m, int col, float acc) {
        out[static_cast<long long>(dst[m]) * cout + col] =
            srk::from_f<T>(acc + srk::to_f(bproj[col]));
      });
}

size_t smem_bytes(int ws, int d) {
  const int n = ws * ws;
  return sizeof(float) * srk::msa_heads_floats(n, d) + sizeof(int) * 2 * n;
}

template <typename T>
cudaError_t launch(const void* x, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, const float* bias,
                   const float* mask, int mask_n, void* o_scr, void* out,
                   int B, int H, int W, int cin, int cloc, int cout, int heads,
                   int ws, int ss, float scale, cudaStream_t stream) {
  const int d = cloc / heads;
  if (d > kMaxD || d * heads != cloc || H % ws || W % ws)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ws, d);
  cudaError_t err = srk::set_smem(msa_block_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B);
  msa_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), bias, mask, mask_n,
      static_cast<T*>(o_scr), static_cast<T*>(out), H, W, cin, cloc, cout,
      heads, ws, ss, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for window ws and head dim
// d; the wrapper holds this against the card's limit before it launches.
extern "C" int sr_msa_block_smem(int ws, int d) {
  return static_cast<int>(smem_bytes(ws, d));
}

// dtype: 0 float32, 1 bfloat16. bias (heads, N, N) and mask (mask_n, N, N)
// are float32; o_scr is a (B, H, W, cloc) scratch image of type dtype.
// Returns the cudaError_t of the launch.
extern "C" int sr_msa_block(int dtype, const void* x, const void* wqkv,
                            const void* bqkv, const void* wproj,
                            const void* bproj, const void* bias,
                            const void* mask, int mask_n, void* o_scr,
                            void* out, int B, int H, int W, int cin, int cloc,
                            int cout, int heads, int ws, int ss, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const float* mf = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, wproj, bproj, bf, mf, mask_n, o_scr,
                         out, B, H, W, cin, cloc, cout, heads, ws, ss, scale,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, bf, mf, mask_n,
                                 o_scr, out, B, H, W, cin, cloc, cout, heads,
                                 ws, ss, scale, st);
  return cudaErrorInvalidValue;
}
