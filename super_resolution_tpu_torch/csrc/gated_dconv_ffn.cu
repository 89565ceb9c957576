// The gated depthwise-conv FFN of a fork-HAT HAB, NHWC:
//
//   y   = LN(x)                      (ln != 0; rounded to T), else y = x
//   h   = y @ W1 + b1                (.., 2M), rounded to T
//   d   = depthwise3x3(h, Wd) + bd   h taken as ZERO outside the image
//   g   = d[:M] * sigmoid(d[M:]) * d[M:]          (rounded to T)
//   out = g @ W2 + b2 (+ x when residual != 0)
//
// Replaces the TPU kernels super_resolution_tpu/ops/pallas_ffn.py:
// gated_dconv_ffn and gated_dconv_ffn_block (both through _run, pallas_call
// at :124). The depthwise conv pads ITS INPUT with zeros: a neighbour
// outside the image contributes 0, not fc1(LN(0)) = b1.
//
// What bounds it on the H100: at the flagship shape (C 180, M 360) the two
// products are 2 * 180 * 720 + 2 * 360 * 180 = 389 kFLOP per pixel against
// 720 bytes of bf16 traffic: 540 FLOP/byte, compute-bound even on the
// tensor cores. This first version runs them as float32 FMA loops on the
// CUDA cores and is bound by them.
//
// Design. The TPU kernel keeps fc1's output for a band of full rows in
// fast memory; a (rows + 2, W + 2, 2M) band does not fit a block's shared
// memory here. The conv is depthwise, so the work is tiled in space AND
// over channels: one block takes a kTile x kTile pixel tile with a
// one-pixel halo (kPos = (kTile + 2)^2 positions). It forms LN once for
// all positions, then loops over chunks of kChunk "proj" channels
// [j, j + kChunk) with their gate partners [M + j, M + j + kChunk): fc1 for
// those 2 kChunk columns on every position (zero where the position is
// outside the image), the 3x3 depthwise conv and the gate on the interior
// pixels, and that chunk's share of fc2 added into a float32 output tile in
// shared memory. Nothing but x and out touches device memory. The halo is
// recomputed by each tile: fc1 runs on 100 positions for 64 pixels, 1.56x
// the work (fc1 is two thirds of the FLOPs, so 1.37x overall). Shared
// memory per block at the flagship shape: 102 kB in bf16 (two blocks per
// SM), 156 kB in float32.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                // interior pixels per side
constexpr int kHalo = kTile + 2;        // positions per side
constexpr int kPos = kHalo * kHalo;     // 100
constexpr int kPix = kTile * kTile;     // 64
constexpr int kChunk = 36;              // proj channels per chunk
constexpr int kCols = 2 * kChunk;       // fc1 columns per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gated_dconv_ffn_kernel(const T* __restrict__ x,
                           const T* __restrict__ gamma,
                           const T* __restrict__ beta,
                           const T* __restrict__ w1, const T* __restrict__ b1,
                           const T* __restrict__ wd, const T* __restrict__ bd,
                           const T* __restrict__ w2, const T* __restrict__ b2,
                           T* __restrict__ out, int H, int W, int C, int M,
                           int cout, int ln, int residual, float eps) {
  extern __shared__ float smem[];
  float* oacc = smem;                    // kPix x cout: fc2 sums, float32
  float* wds = oacc + kPix * cout;       // 10 x kCols: 9 conv taps, conv bias
  int* pix = reinterpret_cast<int*>(wds + 10 * kCols);  // kPos, -1 outside
  T* ys = reinterpret_cast<T*>(pix + kPos);  // kPos x C: LN(x)
  T* hs = ys + kPos * C;                 // kPos x kCols: fc1 of the chunk
  T* gs = hs + kPos * kCols;             // kPix x kChunk: gated product

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile - 1, x0 = blockIdx.x * kTile - 1;
  for (int t = threadIdx.x; t < kPos; t += blockDim.x) {
    const int py = y0 + t / kHalo, px = x0 + t % kHalo;
    pix[t] = (py >= 0 && py < H && px >= 0 && px < W) ? (b * H + py) * W + px
                                                      : -1;
  }
  for (int e = threadIdx.x; e < kPix * cout; e += blockDim.x) oacc[e] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < kPos; t += nwarps) {
    T* yr = ys + t * C;
    if (pix[t] < 0) {  // warp-uniform; fc1 is forced to zero there anyway
      for (int c = lane; c < C; c += 32) yr[c] = srk::from_f<T>(0.f);
      continue;
    }
    const T* xr = x + static_cast<long long>(pix[t]) * C;
    if (ln) {
      float mu, rstd;
      srk::warp_ln_stats([&](int c) { return srk::to_f(xr[c]); }, C, eps, mu,
                         rstd);
      for (int c = lane; c < C; c += 32)
        yr[c] = srk::from_f<T>((srk::to_f(xr[c]) - mu) * rstd *
                                   srk::to_f(gamma[c]) +
                               srk::to_f(beta[c]));
    } else {
      for (int c = lane; c < C; c += 32) yr[c] = xr[c];
    }
  }
  __syncthreads();

  const int m2 = 2 * M;
  for (int j0 = 0; j0 < M; j0 += kChunk) {
    const int kc = min(kChunk, M - j0);
    // column n of the chunk: proj channel j0 + n for n < kc, else its gate
    // partner M + j0 + (n - kc)
    auto col = [&](int n) { return n < kc ? j0 + n : M + j0 + n - kc; };

    for (int e = threadIdx.x; e < 10 * 2 * kc; e += blockDim.x) {
      const int tap = e / (2 * kc), n = e % (2 * kc);
      wds[tap * kCols + n] = srk::to_f(
          tap < 9 ? wd[static_cast<long long>(tap) * m2 + col(n)]
                  : bd[col(n)]);
    }
    srk::block_gemm<4, 4>(
        kPos, 2 * kc, C, [&](int m, int k) { return srk::to_f(ys[m * C + k]); },
        [&](int k, int n) {
          return srk::to_f(w1[static_cast<long long>(k) * m2 + col(n)]);
        },
        [&](int m, int n, float acc) {
          hs[m * kCols + n] = srk::from_f<T>(
              pix[m] < 0 ? 0.f : acc + srk::to_f(b1[col(n)]));
        });
    __syncthreads();

    for (int e = threadIdx.x; e < kPix * kc; e += blockDim.x) {
      const int p = e / kc, j = e % kc;
      const int base = (p / kTile) * kHalo + p % kTile;  // top-left tap
      float dp = 0.f, dg = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const T* hr = hs + (base + dy * kHalo + dx) * kCols;
          const float* wr = wds + (dy * 3 + dx) * kCols;
          dp = fmaf(srk::to_f(hr[j]), wr[j], dp);
          dg = fmaf(srk::to_f(hr[kc + j]), wr[kc + j], dg);
        }
      dp += wds[9 * kCols + j];
      dg += wds[9 * kCols + kc + j];
      const float sig = 1.f / (1.f + expf(-dg));
      gs[p * kChunk + j] = srk::from_f<T>(dp * sig * dg);
    }
    __syncthreads();

    srk::block_gemm<4, 4>(
        kPix, cout, kc,
        [&](int m, int k) { return srk::to_f(gs[m * kChunk + k]); },
        [&](int k, int n) {
          return srk::to_f(w2[static_cast<long long>(j0 + k) * cout + n]);
        },
        [&](int m, int n, float acc) { oacc[m * cout + n] += acc; });
    __syncthreads();  // hs, gs and wds are rewritten by the next chunk
  }

  for (int e = threadIdx.x; e < kPix * cout; e += blockDim.x) {
    const int p = e / cout, n = e % cout;
    const int pos = (p / kTile + 1) * kHalo + p % kTile + 1;
    if (pix[pos] < 0) continue;  // tile overhangs the image
    float o = oacc[e] + srk::to_f(b2[n]);
    if (residual) o += srk::to_f(x[static_cast<long long>(pix[pos]) * C + n]);
    out[static_cast<long long>(pix[pos]) * cout + n] = srk::from_f<T>(o);
  }
}

size_t smem_bytes(int dtype, int C, int cout) {
  const size_t t = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return sizeof(float) * (kPix * cout + 10 * kCols) + sizeof(int) * kPos +
         t * (kPos * C + kPos * kCols + kPix * kChunk);
}

template <typename T>
cudaError_t launch(int dtype, const void* x, const void* gamma,
                   const void* beta, const void* w1, const void* b1,
                   const void* wd, const void* bd, const void* w2,
                   const void* b2, void* out, int B, int H, int W, int C,
                   int M, int cout, int ln, int residual, float eps,
                   cudaStream_t stream) {
  if ((residual && cout != C) || B > 65535 || B < 1 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dtype, C, cout);
  cudaError_t err = srk::set_smem(gated_dconv_ffn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  gated_dconv_ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(wd),
      static_cast<const T*>(bd), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, C, M, cout, ln,
      residual, eps);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_gated_dconv_ffn_smem(int dtype, int C, int cout) {
  return static_cast<int>(smem_bytes(dtype, C, cout));
}

// dtype: 0 float32, 1 bfloat16. x (B, H, W, C); w1 (C, 2M); wd (3, 3, 2M);
// w2 (M, cout); out (B, H, W, cout). gamma and beta are read only when
// ln != 0. Returns the cudaError_t of the launch.
extern "C" int sr_gated_dconv_ffn(int dtype, const void* x, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* wd,
                                  const void* bd, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int C, int M, int cout, int ln,
                                  int residual, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dtype, x, gamma, beta, w1, b1, wd, bd, w2, b2, out,
                         B, H, W, C, M, cout, ln, residual, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dtype, x, gamma, beta, w1, b1, wd, bd, w2,
                                 b2, out, B, H, W, C, M, cout, ln, residual,
                                 eps, st);
  return cudaErrorInvalidValue;
}
