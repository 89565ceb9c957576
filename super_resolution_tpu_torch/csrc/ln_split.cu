// The front LayerNorm of a fork-HAT HAB, NHWC, with the ESC slab split off
// in the same pass:
//
//   ln1 = LN(x)                 (tokens, C), float32 statistics, rounded to T
//   x1  = ln1[:, :pdim]         (tokens, pdim), a compact copy
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_hab.py: ln_split
// (pallas_call at :315). That kernel works on row tiles of the image and
// needs H to be a multiple of the tile; here a token is a token, so any B,
// H and W go through.
//
// What bounds it on the H100: bytes. Per token it reads C values and
// writes C + pdim, with a handful of operations each; at C 180, pdim 16 in
// bf16 that is 752 bytes a token.
//
// Design: one warp per token. The lanes stride over the channels, the mean
// and the centred variance come from warp shuffles, and the second and
// third reads of the row hit L1. The compact slab is written from the
// values already in registers, so the strided slice of the full-width
// tensor is never read back.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_split_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ ln1,
                    T* __restrict__ x1, int n_tok, int C, int pdim,
                    float eps) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tok >= n_tok) return;  // warp-uniform
  const T* xr = x + static_cast<long long>(tok) * C;
  float mu, rstd;
  srk::warp_ln_stats([&](int c) { return srk::to_f(xr[c]); }, C, eps, mu,
                     rstd);
  for (int c = lane; c < C; c += 32) {
    const T y = srk::from_f<T>((srk::to_f(xr[c]) - mu) * rstd *
                                   srk::to_f(gamma[c]) +
                               srk::to_f(beta[c]));
    ln1[static_cast<long long>(tok) * C + c] = y;
    if (c < pdim) x1[static_cast<long long>(tok) * pdim + c] = y;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* ln1, void* x1, int n_tok, int C, int pdim, float eps,
                   cudaStream_t stream) {
  if (pdim < 0 || pdim > C || n_tok < 0) return cudaErrorInvalidValue;
  if (n_tok == 0) return cudaSuccess;
  const int per_block = kThreads / 32;
  const unsigned blocks = (n_tok + per_block - 1) / per_block;
  ln_split_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(ln1), static_cast<T*>(x1),
      n_tok, C, pdim, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x and ln1 are (n_tok, C), x1 (n_tok, pdim).
// Returns the cudaError_t of the launch.
extern "C" int sr_ln_split(int dtype, const void* x, const void* gamma,
                           const void* beta, void* ln1, void* x1, int n_tok,
                           int C, int pdim, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, ln1, x1, n_tok, C, pdim, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, ln1, x1, n_tok, C, pdim, eps,
                                 st);
  return cudaErrorInvalidValue;
}
