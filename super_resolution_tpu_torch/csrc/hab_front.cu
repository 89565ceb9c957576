// The front of a fork-HAT HAB up to its two global pools, NHWC:
//
//   ln1     = LN(x)                              float32 statistics, to T
//   t1      = gelu(conv3x3(ln1; w1) + b1)        C -> MID, zero padding;
//                                                rounded to T before the
//                                                float32 GELU and after it
//   cab     = conv3x3(t1; w2) + b2               MID -> C, zero padding, T
//   gap_cab = sum over pixels of cab             (B, C) float32
//   gap16   = sum over pixels of ln1[..., :pdim] (B, pdim) float32
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_hab.py:hab_front
// (pallas_call at :167, body _hab_front_kernel). Both convs pad THEIR INPUT
// with zeros: ln1 outside the image is 0, and t1 outside the image is 0,
// not gelu(conv1(0)) (pallas_hab.py:101-104). The sums are of the values
// after their cast to T, as the reference takes them. GELU is exact erf
// (erff); the TPU kernel's rational approximation is not copied.
//
// What bounds it on the H100: at the flagship shape (C 180, MID 60) the two
// convs are 9 * 180 * 60 * 2 * 2 = 389 kFLOP a pixel against 1,080 bytes
// of bf16 traffic (x read, ln1 and cab written): 360 FLOP/byte, above the
// tensor cores' ridge, so the operations bound it. This first version runs
// both convs as float32 FMA loops on the CUDA cores and is bound by them.
//
// Design. The TPU kernel reads x three times (the previous, current and
// next row blocks) for the halos of its two convs. Here one block owns a
// kTile x kTile tile of output pixels and forms the LayerNorm of the tile
// with a two-pixel halo once, into shared memory: kLn = 12 x 12 positions,
// zero outside the image. conv1 then runs on the kT1 = 10 x 10 positions of
// the tile with a one-pixel halo (zero outside the image), into shared
// memory as T, and conv2 on the tile's 64 pixels. H and W are arbitrary:
// the ragged last tiles are masked, nothing is padded. The 3 x 3 x 180 x 60
// weights (194 kB in bf16) do not fit beside the tiles, so each conv walks
// its nine taps and stages one tap's (C x MID) slab at a time; a thread
// keeps its TM x TN outputs in registers across the taps. Per block in
// bf16 at the flagship shape: 86 kB of shared memory, two blocks an SM.
// The two sums cross blocks: each block writes its partial sums, (C + pdim)
// float32 a tile, and a second short kernel adds them in tile order, so
// the result does not depend on the schedule (no float atomics).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;              // output pixels per side
constexpr int kT1Side = kTile + 2;    // conv1 positions per side
constexpr int kLnSide = kTile + 4;    // LayerNorm positions per side
constexpr int kPix = kTile * kTile;   // 64
constexpr int kT1 = kT1Side * kT1Side;  // 100
constexpr int kLn = kLnSide * kLnSide;  // 144
// register tiles of the two convs: conv1 5 positions x 5 channels (240
// tiles at MID 60), conv2 4 pixels x 12 channels (240 tiles at C 180)
constexpr int kTM1 = 5, kTN1 = 5;
constexpr int kTM2 = 4, kTN2 = 12;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// out[m][n] += sum_k a[m-th base + tap offset + k] * w[k][n] over the nine
// taps for the thread tiles of one round; the block stages each tap's
// (K x N) slab of w in ws. Calls epi(m, n, acc) for every finished output.
// a_base(m) is the offset of position m's tap-(0, 0) row in `a`, and
// tap_off(dy, dx) the offset a tap adds. Every thread of the block must
// call it, active or not, for the barriers.
template <typename T, int TM, int TN, typename FB, typename FO, typename FE>
__device__ __forceinline__ void conv3x3_taps(const T* a,
                                             const T* __restrict__ w, T* ws,
                                             int M, int N, int K, FB a_base,
                                             FO tap_off, FE epi) {
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  for (int r0 = 0; r0 < tiles; r0 += blockDim.x) {
    const int t = r0 + threadIdx.x;
    const bool active = t < tiles;
    const int m0 = active ? (t / tiles_n) * TM : 0;
    const int n0 = active ? (t % tiles_n) * TN : 0;
    int base[TM], col[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) base[i] = a_base(min(m0 + i, M - 1));
#pragma unroll
    for (int j = 0; j < TN; ++j) col[j] = min(n0 + j, N - 1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the previous slab is no longer read
      const T* wt = w + static_cast<long long>(tap) * K * N;
      for (int e = threadIdx.x; e < K * N; e += blockDim.x) ws[e] = wt[e];
      __syncthreads();
      if (!active) continue;
      const T* at = a + tap_off(tap / 3, tap % 3);
      for (int k = 0; k < K; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = srk::to_f(at[base[i] + k]);
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = srk::to_f(ws[k * N + col[j]]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hab_front_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ ln_out,
                     T* __restrict__ cab_out, float* __restrict__ partial,
                     int H, int W, int C, int MID, int pdim, float eps) {
  extern __shared__ float smem[];
  int* pix = reinterpret_cast<int*>(smem);     // kLn: pixel index, -1 outside
  T* lns = reinterpret_cast<T*>(pix + kLn);    // kLn x C: LN of the patch
  float* cabs = reinterpret_cast<float*>(lns);  // kPix x C, after conv1
  T* t1s = lns + kLn * C;                      // kT1 x MID: gelu(conv1)
  T* ws = t1s + kT1 * MID;                     // C x MID: one tap's weights

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  for (int p = threadIdx.x; p < kLn; p += blockDim.x) {
    const int py = ty0 - 2 + p / kLnSide, px = tx0 - 2 + p % kLnSide;
    pix[p] = (py >= 0 && py < H && px >= 0 && px < W) ? (b * H + py) * W + px
                                                      : -1;
  }
  __syncthreads();

  // LayerNorm of every position of the patch, one warp a position; the
  // tile's own pixels are also ln1's output
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < kLn; p += blockDim.x >> 5) {
    T* yr = lns + p * C;
    if (pix[p] < 0) {  // warp-uniform: conv1's zero padding
      for (int c = lane; c < C; c += 32) yr[c] = srk::from_f<T>(0.f);
      continue;
    }
    const long long off = static_cast<long long>(pix[p]) * C;
    const T* xr = x + off;
    float mu, rstd;
    srk::warp_ln_stats([&](int c) { return srk::to_f(xr[c]); }, C, eps, mu,
                       rstd);
    const int py = p / kLnSide, px = p % kLnSide;
    const bool own = py >= 2 && py < kTile + 2 && px >= 2 && px < kTile + 2;
    for (int c = lane; c < C; c += 32) {
      const T v = srk::from_f<T>((srk::to_f(xr[c]) - mu) * rstd *
                                     srk::to_f(gamma[c]) +
                                 srk::to_f(beta[c]));
      yr[c] = v;
      if (own) ln_out[off + c] = v;
    }
  }
  __syncthreads();

  // this tile's share of gap16, in pixel order (0 outside the image)
  float* part = partial + (static_cast<long long>(b) * gridDim.x * gridDim.y +
                           tile) * (C + pdim);
  for (int c = threadIdx.x; c < pdim; c += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < kPix; ++p)
      s += srk::to_f(lns[((p / kTile + 2) * kLnSide + p % kTile + 2) * C + c]);
    part[C + c] = s;
  }

  // conv1 on the 10 x 10 positions: position m of the t1 grid reads the LN
  // grid from (m / 10, m % 10) on
  conv3x3_taps<T, kTM1, kTN1>(
      lns, w1, ws, kT1, MID, C,
      [&](int m) { return ((m / kT1Side) * kLnSide + m % kT1Side) * C; },
      [&](int dy, int dx) { return (dy * kLnSide + dx) * C; },
      [&](int m, int n, float acc) {
        const int py = ty0 - 1 + m / kT1Side, px = tx0 - 1 + m % kT1Side;
        const bool in = py >= 0 && py < H && px >= 0 && px < W;
        const float h = srk::round_to<T>(acc + srk::to_f(b1[n]));
        t1s[m * MID + n] = srk::from_f<T>(in ? gelu(h) : 0.f);
      });
  __syncthreads();  // t1s complete; lns is no longer read

  // conv2 on the tile's 64 pixels: pixel p reads the t1 grid from
  // (p / 8, p % 8) on
  conv3x3_taps<T, kTM2, kTN2>(
      t1s, w2, ws, kPix, C, MID,
      [&](int p) { return ((p / kTile) * kT1Side + p % kTile) * MID; },
      [&](int dy, int dx) { return (dy * kT1Side + dx) * MID; },
      [&](int p, int n, float acc) {
        const int q = pix[(p / kTile + 2) * kLnSide + p % kTile + 2];
        const T v = srk::from_f<T>(acc + srk::to_f(b2[n]));
        if (q >= 0) cab_out[static_cast<long long>(q) * C + n] = v;
        cabs[p * C + n] = q >= 0 ? srk::to_f(v) : 0.f;
      });
  __syncthreads();

  // this tile's share of gap_cab, in pixel order
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < kPix; ++p) s += cabs[p * C + c];
    part[c] = s;
  }
}

// gap_cab and gap16 of image b: the tiles' partial sums added in tile order.
__global__ void __launch_bounds__(kThreads)
    hab_front_sum_kernel(const float* __restrict__ partial,
                         float* __restrict__ gap_cab,
                         float* __restrict__ gap16, int B, int tiles, int C,
                         int pdim) {
  const int width = C + pdim;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * width) return;
  const int b = e / width, ch = e % width;
  const float* p = partial + static_cast<long long>(b) * tiles * width + ch;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<long long>(t) * width];
  if (ch < C)
    gap_cab[b * C + ch] = s;
  else
    gap16[b * pdim + ch - C] = s;
}

// The LN patch also holds conv2's float32 outputs once conv1 is done:
// kPix * 4 <= kLn * 2 bytes a channel, for both types.
static_assert(kPix * sizeof(float) <= kLn * sizeof(__nv_bfloat16),
              "conv2's outputs must fit the LN patch");

size_t smem_bytes(int dtype, int C, int MID) {
  const size_t t = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  return sizeof(int) * kLn + t * (kLn * C + kT1 * MID + C * MID);
}

template <typename T>
cudaError_t launch(int dtype, const void* x, const void* gamma,
                   const void* beta, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* ln_out,
                   void* cab_out, float* partial, float* gap_cab,
                   float* gap16, int B, int H, int W, int C, int MID,
                   int pdim, float eps, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || MID < 1 || pdim < 0 ||
      pdim > C)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dtype, C, MID);
  cudaError_t err = srk::set_smem(hab_front_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  hab_front_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(ln_out),
      static_cast<T*>(cab_out), partial, H, W, C, MID, pdim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * (C + pdim);
  hab_front_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(partial, gap_cab, gap16, B,
                                   grid.x * grid.y, C, pdim);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_hab_front_smem(int dtype, int C, int MID) {
  return static_cast<int>(smem_bytes(dtype, C, MID));
}

// dtype: 0 float32, 1 bfloat16. x (B, H, W, C); gamma, beta, b2 (C,);
// w1 (3, 3, C, MID), b1 (MID,); w2 (3, 3, MID, C); ln_out, cab_out
// (B, H, W, C); partial: float32 scratch of B * ceil(H / 8) * ceil(W / 8) *
// (C + pdim) elements; gap_cab (B, C) and gap16 (B, pdim) float32. Returns
// the cudaError_t of the launches.
extern "C" int sr_hab_front(int dtype, const void* x, const void* gamma,
                            const void* beta, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* ln_out,
                            void* cab_out, void* partial, void* gap_cab,
                            void* gap16, int B, int H, int W, int C, int MID,
                            int pdim, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* gc = static_cast<float*>(gap_cab);
  float* g16 = static_cast<float*>(gap16);
  if (dtype == 0)
    return launch<float>(dtype, x, gamma, beta, w1, b1, w2, b2, ln_out,
                         cab_out, p, gc, g16, B, H, W, C, MID, pdim, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dtype, x, gamma, beta, w1, b1, w2, b2,
                                 ln_out, cab_out, p, gc, g16, B, H, W, C, MID,
                                 pdim, eps, st);
  return cudaErrorInvalidValue;
}
