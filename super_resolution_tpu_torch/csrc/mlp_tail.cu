// The MLP tail of the classic HAT blocks, NHWC:
//
//   x   = s                                     (mlp_block)
//   x   = s + a + cs * cv                       (mlp_block_sum3, float32 sum)
//   x   = s + roll(a, (+ss, +ss)) + cs * cv     (mlp_block_sum3_shifted)
//   out = rs * x + fc2(gelu(fc1(LN(x))))
//
// Replaces the TPU kernels of super_resolution_tpu/ops/pallas_ffn.py:
// mlp_block (pallas_call at :367), mlp_block_sum3 (:503) and
// mlp_block_sum3_shifted (:571). The shifted form reads the attention
// input at ((y - ss) mod H, (x - ss) mod W), so the SW-MSA roll-back costs
// no pass of its own; Mosaic's wrap strip is not needed.
//
// What bounds it on the H100: at the flagship shape (C 180, hidden 360) the
// two products are 2 * 2 * 180 * 360 = 259 kFLOP per pixel against
// 4 * 180 * 2 = 1.4 kB of bf16 traffic for the sum3 form: 180 FLOP/byte,
// under the 295 FLOP/byte ridge of the bf16 tensor cores, so a tensor-core
// version would be memory-bound. This first version runs its products as
// float32 FMA loops on the CUDA cores and is bound by them (and by the L1
// traffic of the weight reads) instead.
//
// Design: one block takes kRows pixels. The float32 block input, its
// LayerNorm (rounded to T as the reference casts before fc1) and
// gelu(fc1) (rounded to T before fc2) stay in shared memory, so the
// hidden activation never reaches device memory
// (block_parts.cuh::mlp_tail_rows). GELU is the exact erff form; the TPU
// kernel uses the A&S approximation of erf (error < 1.5e-7).
#include "block_parts.cuh"

namespace {

constexpr int kRows = srk::kTailRows;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_tail_kernel(const T* __restrict__ s, const T* __restrict__ a,
                    const T* __restrict__ cv, const T* __restrict__ gamma,
                    const T* __restrict__ beta, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ out,
                    long long n_pix, int H, int W, int C, int hid, int sum3,
                    int ss, float cs, float eps, float rs) {
  extern __shared__ float smem[];
  float* xs = smem;              // kRows x C: block input, float32
  float* ys = xs + kRows * C;    // kRows x C: LN(x) rounded to T
  float* gs = ys + kRows * C;    // kRows x hid: gelu(fc1) rounded to T

  const long long p0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n_pix - p0));

  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    const long long p = p0 + r;
    float v = srk::to_f(s[p * C + c]);
    if (sum3) {
      long long pa = p;
      if (ss) {
        const int x = static_cast<int>(p % W);
        const long long t = p / W;
        const int y = static_cast<int>(t % H);
        const long long b = t / H;
        const int ya = ((y - ss) % H + H) % H;
        const int xa = ((x - ss) % W + W) % W;
        pa = (b * H + ya) * W + xa;
      }
      v = v + srk::to_f(a[pa * C + c]) + srk::to_f(cv[p * C + c]) * cs;
    }
    xs[e] = v;
  }
  __syncthreads();

  srk::mlp_tail_rows<T>(xs, ys, gs, rows, C, hid, gamma, beta, w1, b1, w2, b2,
                        eps, rs, [&](int m, int n, float o) {
                          out[(p0 + m) * C + n] = srk::from_f<T>(o);
                        });
}

template <typename T>
cudaError_t launch(const void* s, const void* a, const void* cv,
                   const void* gamma, const void* beta, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* out,
                   int B, int H, int W, int C, int hid, int sum3, int ss,
                   float cs, float eps, float rs, cudaStream_t stream) {
  const long long n_pix = static_cast<long long>(B) * H * W;
  const size_t smem = sizeof(float) * srk::mlp_tail_floats(C, hid);
  cudaError_t err = srk::set_smem(mlp_tail_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n_pix + kRows - 1) / kRows);
  mlp_tail_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(a),
      static_cast<const T*>(cv), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), n_pix, H, W, C, hid,
      sum3, ss, cs, eps, rs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. a and cv are read only when sum3 != 0.
// Returns the cudaError_t of the launch.
extern "C" int sr_mlp_tail(int dtype, const void* s, const void* a,
                           const void* cv, const void* gamma, const void* beta,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int B, int H, int W,
                           int C, int hid, int sum3, int ss, float cs,
                           float eps, float rs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(s, a, cv, gamma, beta, w1, b1, w2, b2, out, B, H, W,
                         C, hid, sum3, ss, cs, eps, rs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(s, a, cv, gamma, beta, w1, b1, w2, b2, out,
                                 B, H, W, C, hid, sum3, ss, cs, eps, rs, st);
  return cudaErrorInvalidValue;
}
