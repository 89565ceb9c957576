// The whole unshifted classic HAT block after norm1 and the CAB, NHWC:
//
//   per ws x ws window:
//     attn = concat_h(softmax(q_h k_h^T * scale + RPB_h) v_h) @ Wproj + b,
//            qkv = ln_x @ Wqkv + b              (rounded to T)
//     x    = shortcut + attn + cs * conv_x      (float32)
//     out  = x + fc2(gelu(fc1(LN2(x))))
//
// Replaces the TPU kernel of super_resolution_tpu/ops/pallas_attention.py:
// fused_hab_block (pallas_call at :1707, body _hab_block_kernel
// :1621-1661). As there, attn stays float32 into the 3-way sum; the plain
// version rounds it to T first, as the JAX reference does.
//
// What bounds it on the H100: the work of msa_block.cu and mlp_tail.cu
// together (per window at the flagship shape 113 MFLOP of attention and
// projections and 66 MFLOP of MLP) less one write and one read of the
// attention image: 72 GFLOP at the flagship chunk, 0.073 ms at 989
// TFLOP/s, beside 157 M exponentials, 0.040 ms on the special-function
// units.
//
// In bf16 it is three launches behind sr_mma_hab_block, every product on
// the tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums), made
// of the bf16 parts of fused_msa_block and the MLP tail:
//   mma_proj_bias_kernel      (msa_block.cu) qkv = ln_x Wqkv + b, rounded
//                             once, into a (B, H, W, 3C) scratch image;
//   mma_msa_attention_kernel  (msa_attention.cu, unmasked, unshifted) with
//                             the RPB, the head concat rounded once into a
//                             (B, H, W, C) scratch image; it rounds the
//                             unnormalised p = exp(s - m) to bf16 and
//                             divides by the float32 denominator, where
//                             the TPU kernel rounds p normalised
//                             (pallas_attention.py:1646-1648);
//   mma_hab_tail_kernel       (mlp_tail.cu) mma_mlp_tail_kernel with the
//                             output projection in front: a warp starts its
//                             16 pixels' C-wide float32 accumulators at
//                             shortcut + cs * conv_x + b_proj, adds the
//                             concat rows (its A tile) times Wproj's rows
//                             (through the weight stages, as fc2's W2
//                             rows), and the 3-way sum x is there in
//                             float32; then LN2, fc1, GELU, fc2 and the
//                             residual as in the tail.
// The projected attention never reaches device memory, as in the TPU
// kernel; the head concat does (bf16, where the TPU kernel keeps it in
// VMEM): 37 MB written and read at the flagship chunk, against the split
// route's (rows 1 + 3) projected image and its launch.
//
// In float32 it is the FMA kernel below, the first version and the exact
// check on the card; its entry refuses bf16. Design: one block per window,
// the two halves of block_parts.cuh in turn. The attention runs as in
// msa_block.cu (per head q, k, v and 16 score rows in shared memory, the
// head concat in a wrapper-allocated scratch image). A 256 x 180 float32
// tile of attn does not fit beside either half, so the block then walks
// its window's tokens 32 at a time: output projection of the 32 rows, the
// 3-way sum with x and conv_x read at the window's pixels, then LN2, fc1,
// GELU, fc2 and the residual as in mlp_tail.cu, in the shared memory the
// attention no longer needs. At the flagship shape: 110 kB a block, two
// blocks an SM.
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

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_hab_block's. bias (heads, N, N) is float32; o_scr is a (B, H, W,
// C) float32 scratch image. Returns the cudaError_t of the launch.
extern "C" int sr_hab_block(int dtype, const void* lnx, const void* x,
                            const void* cv, const void* wqkv,
                            const void* bqkv, const void* wproj,
                            const void* bproj, const void* bias,
                            const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* o_scr, void* out, int B,
                            int H, int W, int C, int hid, int heads, int ws,
                            float scale, float cs, float eps, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch<float>(lnx, x, cv, wqkv, bqkv, wproj, bproj,
                       static_cast<const float*>(bias), gamma, beta, w1, b1,
                       w2, b2, o_scr, out, B, H, W, C, hid, heads, ws, scale,
                       cs, eps, static_cast<cudaStream_t>(stream));
}

// The three launches of the bf16 route, from their sources: the qkv
// projection (msa_block.cu), the attention of fused_msa_attention
// (msa_attention.cu) and the tail (mlp_tail.cu), with their shared memory.
extern "C" int sr_mma_proj_bias(const void* a, const void* w, const void* b,
                                void* out, long long m, int k, int n,
                                void* stream);
extern "C" int sr_mma_msa_attention(const void* qkv, const void* bias,
                                    const void* mask, int n_mask, void* out,
                                    int B, int H, int W, int C, int heads,
                                    int ws, int ss, float scale,
                                    void* stream);
extern "C" int sr_mma_hab_tail(const void* s, const void* o, const void* cv,
                               const void* wproj, const void* bproj,
                               const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int B, int H,
                               int W, int C, int hid, float cs, float eps,
                               void* stream);
extern "C" int sr_mma_msa_block_smem(int cin, int cloc);
extern "C" int sr_mma_msa_attention_smem(int d, int masked);
extern "C" int sr_mma_mlp_tail_smem(int C);

// The most dynamic shared memory a block of the bf16 route's three
// launches needs at C channels in heads heads, whatever the window and the
// hidden width.
extern "C" int sr_mma_hab_block_smem(int C, int heads) {
  const int a = sr_mma_msa_block_smem(C, C);
  const int b = sr_mma_msa_attention_smem(C / heads, 0);
  const int c = sr_mma_mlp_tail_smem(C);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// fused_hab_block in bf16 on the tensor cores: operands as sr_hab_block's
// in bf16 (bias float32); qkv_scr (B, H, W, 3C) and o_scr (B, H, W, C) are
// bf16 scratch images. Launches qkv = lnx Wqkv + bqkv (rounded), the
// unmasked, unshifted attention with the RPB into the head concat o_scr
// (rounded), and the tail, which projects the concat into its float32
// accumulators, in turn on the stream. Head dims up to kMsaMaxD, C up to
// 255. Returns the first cudaError_t that is not cudaSuccess, or
// cudaSuccess.
extern "C" int sr_mma_hab_block(const void* lnx, const void* x,
                                const void* cv, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const void* bias,
                                const void* gamma, const void* beta,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                void* qkv_scr, void* o_scr, void* out, int B,
                                int H, int W, int C, int hid, int heads,
                                int ws, float scale, float cs, float eps,
                                void* stream) {
  if (B < 1 || heads < 1 || C % heads || C / heads > srk::kMsaMaxD ||
      ws < 1 || H % ws || W % ws)
    return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(B) * H * W;
  int err = sr_mma_proj_bias(lnx, wqkv, bqkv, qkv_scr, m, C, 3 * C, stream);
  if (err) return err;
  err = sr_mma_msa_attention(qkv_scr, bias, nullptr, 0, o_scr, B, H, W, C,
                             heads, ws, 0, scale, stream);
  if (err) return err;
  return sr_mma_hab_tail(x, o_scr, cv, wproj, bproj, gamma, beta, w1, b1, w2,
                         b2, out, B, H, W, C, hid, cs, eps, stream);
}
