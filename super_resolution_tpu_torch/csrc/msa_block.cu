// The (shifted) window self-attention half of a classic HAT block, NHWC,
// with its qkv and output projections:
//
//   per ws x ws window of x (read at ((y + ss) mod H, (x + ss) mod W)):
//     qkv = x @ Wqkv + b                       (rounded to T)
//     o_h = softmax(q_h k_h^T * scale + RPB_h + mask_w) v_h   for each head
//     out = concat_h(o_h) @ Wproj + b           (written in rolled space)
//
// Replaces the TPU kernels of super_resolution_tpu/ops/pallas_attention.py:
// fused_msa_block (pallas_call at :948, body _msa_block_kernel :859) and
// fused_msa_block_shifted (:1063, body :870). The shift is an argument:
// with ss > 0 q, k and v are read at the rolled pixels, so the cyclic roll
// of the input costs nothing and the output stays in rolled space, as the
// TPU kernel leaves it. The rolled-space shift mask is read from the
// (nW, N, N) tensor the caller passes; an unshifted block passes none (a
// (1, N, N) tensor passed is read for every window, as the JAX reference
// adds it).
//
// What bounds it on the H100: per window at the flagship shape (N 256,
// C 180, 6 heads of 30) the products are 2 * 256 * 180 * 720 = 66 MFLOP
// of projections and 4 * 6 * 256 * 256 * 30 = 47 MFLOP of attention,
// against 2 * 256 * 180 * 2 = 184 kB of bf16 image traffic: about
// 600 FLOP/byte, compute-bound even on the tensor cores. At the chunk (400
// windows) that is 45 GFLOP, 0.046 ms at 989 TFLOP/s, beside 157 M
// exponentials, 0.040 ms on the special-function units.
//
// In bf16 it is three launches behind one entry, every product on the
// tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums):
//   mma_proj_bias_kernel      a block per 128 pixels (mma_proj.cuh's
//                             project_rows): qkv = x Wqkv + b, rounded
//                             once, into the caller's (B, H, W, 3 cloc)
//                             scratch image, of the unrolled image: a
//                             projection works pixel by pixel, roll(x) W =
//                             roll(x W), so the shift needs no gather here;
//   mma_msa_attention_kernel  fused_msa_attention's (msa_attention.cu,
//                             through its C entry) on that image, with the
//                             shift: token i of a rolled window reads q, k
//                             and v ss rows and columns on, cyclically,
//                             and writes its output at its own pixel into
//                             the (B, H, W, cloc) head-concat image; no
//                             mask, the unmasked template;
//   mma_proj_bias_kernel      again: out = concat Wproj + bproj, rounded
//                             once.
// A block's 128 rows are contiguous pixels, so a projection's output tile
// is one byte range: the stores go through shared memory and leave as
// whole runs of each row (mma_proj.cuh). qkv through the HBM is 110 MB
// written and read again at the chunk, about 0.07 ms. The cast points of
// the attention are the online softmax's (p = exp(s - m) rounded to bf16
// unnormalised, the output divided by the float32 denominator), where the
// TPU kernel normalises p before its cast (pallas_attention.py:841-846).
//
// In float32 it is the FMA kernel below, the first version, the exact
// check of the algorithm on the card; its entry refuses bf16. It runs
// every product as float32 FMA loops on the CUDA cores and is bound by
// them. Design: one block per window. Per head, q, k and v (256 x 30 each,
// float32) sit in shared memory; scores are formed for 16 query rows at a
// time (16 x 256 float32; block_parts.cuh::msa_window_heads), so the
// 256 x 256 score matrix never exists whole. The concatenated head
// outputs go to a wrapper-allocated scratch image; after a block barrier
// the same block applies the output projection to its own window. Shared memory per block at the flagship
// shape: 108 kB, two blocks per SM.
#include <stdint.h>

#include "block_parts.cuh"
#include "mma_proj.cuh"

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

bool bad_shape(int B, int H, int W, int cloc, int heads, int ws, int ss) {
  return B < 1 || heads < 1 || cloc % heads || cloc / heads > kMaxD ||
         ws < 1 || H % ws || W % ws || ss < 0 || ss >= ws;
}

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;

struct ProjArgs {
  const bf16* a;  // (m, k), the rows
  const bf16* w;  // (k, n)
  const bf16* b;  // (n,)
  long long m;
  int k, n;
  bool vec_a, vec_w;  // 8-byte copies of a's rows; of w's rows
  mma::RowsOut out;   // (m, n)
};

// out = round(a w + b) for kProjRows rows.
__global__ void __launch_bounds__(mma::kProjThreads)
    mma_proj_bias_kernel(ProjArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, n = a.n;
  const long long row0 = static_cast<long long>(blockIdx.x) * mma::kProjRows;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + 2 * mma::kProjRows * mma::a_stride(k);
  mma::stage_rows(at, a.a, k, row0, a.m, k, a.vec_a);
  mma::RowsOut dst = a.out;
  dst.row0 = row0;
  const bf16 zero = __float2bfloat16(0.f);
  mma::project_rows(
      at, k, n,
      [&](int r, int c) { return a.w + static_cast<long long>(r) * n + c; },
      a.vec_w, stages, [] {},
      [&](int, int c) {
        return mma::pack(a.b[c], c + 1 < n ? a.b[c + 1] : zero);
      },
      [&](int, int, float v0, float v1, uint32_t b2) {
        const float2 bb = mma::unpack(b2);
        return mma::pack(v0 + bb.x, v1 + bb.y);
      },
      dst);
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// round(a w + b) of m rows into out, a kernel launch on the stream.
cudaError_t project(const void* a, const void* w, const void* b, void* out,
                    long long m, int k, int n, cudaStream_t stream) {
  ProjArgs p;
  p.a = static_cast<const bf16*>(a);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const bf16*>(b);
  p.m = m;
  p.k = k;
  p.n = n;
  // rows of k and n values: whole 8-byte pieces where both are multiples
  // of 4
  p.vec_a = k % 4 == 0 && aligned(a, 8);
  p.vec_w = n % 4 == 0 && aligned(w, 8);
  p.out = mma::rows_out(out, m, n);
  const int smem = mma::proj_smem_bytes(k);
  cudaError_t err = srk::set_smem(mma_proj_bias_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks =
      static_cast<int>((m + mma::kProjRows - 1) / mma::kProjRows);
  mma_proj_bias_kernel<<<blocks, mma::kProjThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// round(a w + b) of m rows of a (m, k) bf16 matrix by a (k, n) weight into
// out (m, n): one launch of mma_proj_bias_kernel on the stream, the qkv
// projection of fused_hab_block's bf16 route (hab_block.cu). Returns the
// cudaError_t of the launch.
extern "C" int sr_mma_proj_bias(const void* a, const void* w, const void* b,
                                void* out, long long m, int k, int n,
                                void* stream) {
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  return tc::project(a, w, b, out, m, k, n,
                     static_cast<cudaStream_t>(stream));
}

// fused_msa_attention's tensor-core entry (msa_attention.cu), the middle of
// the bf16 block.
extern "C" int sr_mma_msa_attention(const void* qkv, const void* bias,
                                    const void* mask, int n_mask, void* out,
                                    int B, int H, int W, int C, int heads,
                                    int ws, int ss, float scale,
                                    void* stream);

// Bytes of dynamic shared memory one block needs for window ws and head dim
// d; the wrapper holds this against the card's limit before it launches.
extern "C" int sr_msa_block_smem(int ws, int d) {
  return static_cast<int>(smem_bytes(ws, d));
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_msa_block's. bias (heads, N, N) and mask (mask_n, N, N) are
// float32, mask null for none (mask_n 1); o_scr is a (B, H, W, cloc)
// float32 scratch image. Returns the cudaError_t of the launch.
extern "C" int sr_msa_block(int dtype, const void* x, const void* wqkv,
                            const void* bqkv, const void* wproj,
                            const void* bproj, const void* bias,
                            const void* mask, int mask_n, void* o_scr,
                            void* out, int B, int H, int W, int cin, int cloc,
                            int cout, int heads, int ws, int ss, float scale,
                            void* stream) {
  if (dtype != 0 || bad_shape(B, H, W, cloc, heads, ws, ss))
    return cudaErrorInvalidValue;
  return launch<float>(x, wqkv, bqkv, wproj, bproj,
                       static_cast<const float*>(bias),
                       static_cast<const float*>(mask), mask_n, o_scr, out,
                       B, H, W, cin, cloc, cout, heads, ws, ss, scale,
                       static_cast<cudaStream_t>(stream));
}

// The most dynamic shared memory a block of the bf16 route's two
// projection launches needs (the attention's is
// sr_mma_msa_attention_smem's).
extern "C" int sr_mma_msa_block_smem(int cin, int cloc) {
  const int a = srk::mma::proj_smem_bytes(cin);
  const int b = srk::mma::proj_smem_bytes(cloc);
  return a > b ? a : b;
}

// fused_msa_block(_shifted) in bf16 on the tensor cores: operands as
// sr_msa_block's in bf16 (bias and mask float32, mask null for none);
// qkv_scr (B, H, W, 3 cloc) and o_scr (B, H, W, cloc) are bf16 scratch
// images. A shifted call (ss > 0) needs its mask. Launches the qkv
// projection, the tensor-core attention of fused_msa_attention and the
// output projection in turn on the stream. Returns the first cudaError_t
// that is not cudaSuccess, or cudaSuccess.
extern "C" int sr_mma_msa_block(const void* x, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const void* bias,
                                const void* mask, int mask_n, void* qkv_scr,
                                void* o_scr, void* out, int B, int H, int W,
                                int cin, int cloc, int cout, int heads,
                                int ws, int ss, float scale, void* stream) {
  if (bad_shape(B, H, W, cloc, heads, ws, ss) || (ss && mask == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long m = static_cast<long long>(B) * H * W;
  cudaError_t err = tc::project(x, wqkv, bqkv, qkv_scr, m, cin, 3 * cloc, st);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(
      sr_mma_msa_attention(qkv_scr, bias, mask, mask == nullptr ? 0 : mask_n,
                           o_scr, B, H, W, cloc, heads, ws, ss, scale,
                           stream));
  if (err != cudaSuccess) return err;
  return tc::project(o_scr, wproj, bproj, out, m, cloc, cout, st);
}
