// The front of a fork-HAT HAB up to its two global pools, NHWC:
//
//   ln1     = LN(x)                              float32 statistics, to T
//   t1      = gelu(conv3x3(ln1; w1) + b1)        C -> MID, zero padding, T
//   cab     = conv3x3(t1; w2) + b2               MID -> C, zero padding, T
//   gap_cab = sum over pixels of cab             (B, C) float32
//   gap16   = sum over pixels of ln1[..., :pdim] (B, pdim) float32
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_hab.py:hab_front
// (pallas_call at :167, body _hab_front_kernel :53-132). Both convs pad
// THEIR INPUT with zeros: ln1 outside the image is 0, and t1 outside the
// image is 0, not gelu(conv1(0)) (pallas_hab.py:101-104).
//
// What bounds it on the H100: at the flagship shape (C 180, MID 60) the two
// convs are 9 * 180 * 60 * 2 * 2 = 389 kFLOP a pixel against 1,080 bytes
// of bf16 traffic (x read, ln1 and cab written): 360 FLOP/byte, above the
// tensor cores' ridge, so the operations bound it: 39.8 GFLOP at the
// flagship chunk of four 160 x 160 tiles, 0.040 ms at 989 TFLOP/s.
//
// In bf16 it is mma_hab_front_kernel (namespace tc), both convs as implicit
// GEMMs on the tensor cores (mma.sync.m16n8k16, bf16 operands, float32
// sums), at the TPU kernel's cast points: GELU (the A&S erf) on the
// unrounded conv1 + b1 in float32, t1 rounded once; gap_cab summed from the
// float32 cab; gap16 from the rounded ln1. A block of kWarps = 8 warps
// takes an 8 x 16 interior tile:
//   prologue  the 12 x 20 positions of the tile's two-pixel halo: rows of x
//             into an A tile by cp.async (zero outside the image and past
//             C, C rounded up to 16), LayerNorm in place, one warp a row,
//             rounded to bf16; the tile's own rows are ln1's output, and
//             their first pdim channels the tile's share of gap16;
//   conv1     M the 10 x 18 = 180 positions of the one-pixel halo (12 m16
//             tiles), N MID rounded up to 16 (above 16 to 32), K 9 taps x
//             C: a lane hands ldmatrix its own position's LN row plus the
//             tap's offset, so the im2col gather costs nothing; each tap's
//             (C x MID) weight slab comes through kStages = 2 shared-memory
//             stages by cp.async, the next slab in flight; a warp holds 3
//             m16 tiles by 32 (or 16) columns; epilogue + b1, GELU, exactly
//             0 outside the image, rounded into a t1 tile that takes the LN
//             tile's place;
//   conv2     M the 128 interior pixels, N C rounded up to 16 NH, K 9 taps
//             x MID rounded up: a warp holds 2 m16 tiles (two interior rows)
//             by half of N, the slabs through the same stages;
//   epilogue  + b2, cab rounded and stored as bf16 pairs; the tile's column
//             sums of the float32 cab by shuffles over the accumulators, the
//             warps' sums added in warp order into the tile's partial.
// Shared memory (tc::smem_bytes, twin cuda_hab.mma_hab_front_smem): the LN
// tile and two stages, 151,296 bytes at C 180 / MID 60 (one block an SM),
// 86,784 at HAT-S's C 144 / MID 6. Each block reads both weight tensors
// from the L2: 389 kB at C 180.
//
// In float32 it is hab_front_kernel below, the first version and the exact
// check on the card; its entry refuses bf16. It rounds where the JAX
// reference rounds (ln1, conv1's output before the float32 GELU, the GELU
// after it, cab before the sums) and takes the exact erf (erff). The TPU
// kernel reads x three times (the previous, current and next row blocks)
// for the halos of its two convs. Here one block owns a kTile x kTile tile
// of output pixels and forms the LayerNorm of the tile with a two-pixel
// halo once, into shared memory: kLn = 12 x 12 positions, zero outside the
// image. conv1 then runs on the kT1 = 10 x 10 positions of the tile with a
// one-pixel halo (zero outside the image), into shared memory as T, and
// conv2 on the tile's 64 pixels. H and W are arbitrary: the ragged last
// tiles are masked, nothing is padded. Each conv walks its nine taps and
// stages one tap's (C x MID) slab at a time; a thread keeps its TM x TN
// outputs in registers across the taps, as float32 FMA loops.
//
// Both kernels write their partial sums, (C + pdim) float32 a tile, and a
// second short kernel adds them in tile order, so the result does not
// depend on the schedule (no float atomics).
#include <stdint.h>

#include "common.cuh"
#include "mma_attention.cuh"

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

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;
using srk::DivMod;

constexpr int kWarps = 8;
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kTileY = 8;                 // interior rows of a block
constexpr int kTileX = 16;                // interior columns
constexpr int kT1Y = kTileY + 2, kT1X = kTileX + 2;  // conv1's positions
constexpr int kLnY = kTileY + 4, kLnX = kTileX + 4;  // LayerNorm's positions
constexpr int kT1Pos = kT1Y * kT1X;                  // 180
constexpr int kT1Tiles = (kT1Pos + 15) / 16;         // 12 m16 tiles
constexpr int kLnPos = kLnY * kLnX;                  // 240
constexpr int kPix = kTileY * kTileX;                // 128
constexpr int kConv1Tiles = 3;  // conv1's m16 tiles a warp holds
constexpr int kConv2Tiles = 2;  // conv2's m16 tiles a warp holds
constexpr int kMGroups1 = (kT1Tiles + kConv1Tiles - 1) / kConv1Tiles;  // 4
constexpr int kMGroups2 = kPix / 16 / kConv2Tiles;                      // 4
constexpr int kStages = 2;   // weight stages: the next slab in flight
constexpr int kTaps = 18;    // conv1's nine slabs, then conv2's
constexpr int kPad = 8;      // bf16 after each row of a tile or stage
constexpr int kMaxMid = 64;  // conv1's widest N: two groups of 32 columns
constexpr int kMaxC = 256;   // conv2's widest N: 2 x 8 NH with NH 16
constexpr int kLnPairs = kMaxC / 64;  // channel pairs of a lane's LN row
static_assert(kPix % (16 * kConv2Tiles) == 0, "whole conv2 jobs");
static_assert(2 * kMGroups2 <= kWarps, "one conv2 job a warp");
static_assert(2 * kMGroups1 <= kWarps, "one conv1 job a warp");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// conv1's K a tap: C rounded up to 16
__host__ __device__ constexpr int c_width(int c) { return (c + 15) / 16 * 16; }

// conv1's N and conv2's K a tap: MID rounded up to 16, above 16 to 32, so
// that a warp's columns are 16 or 32 wide
__host__ __device__ constexpr int mid_width(int mid) {
  return mid <= 16 ? 16 : (mid + 31) / 32 * 32;
}

// n8 tiles of half of conv2's N: C rounded up to 16 NH
__host__ __device__ constexpr int nh_of(int c) { return c <= 192 ? 12 : 16; }

// Bytes of a stage: the larger of a conv1 slab (c_width rows of the padded
// mid_width) and a conv2 slab (mid_width rows of 16 NH + kPad).
__host__ __device__ constexpr int stage_bytes(int c, int mid) {
  return 2 * cmax(c_width(c) * (mid_width(mid) + kPad),
                  mid_width(mid) * (16 * nh_of(c) + kPad));
}

// Bytes of the A tile: the LN tile, which the t1 tile takes over.
__host__ __device__ constexpr int a_bytes(int c, int mid) {
  return 2 * cmax(kLnPos * (c_width(c) + kPad),
                  kT1Tiles * 16 * (mid_width(mid) + kPad));
}

// The A tile and kStages stages, which the conv2 warps' column sums reuse.
__host__ __device__ constexpr int smem_bytes(int c, int mid) {
  return a_bytes(c, mid) + cmax(kStages * stage_bytes(c, mid),
                                4 * kMGroups2 * 16 * nh_of(c));
}

// A 4-byte aligned bf16 pair as floats.
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct FrontArgs {
  const bf16* x;  // (B, H, W, C)
  const bf16* gamma;
  const bf16* beta;
  const bf16* w1;  // (3, 3, C, MID)
  const bf16* b1;
  const bf16* w2;  // (3, 3, MID, C)
  const bf16* b2;
  bf16* ln_out;    // (B, H, W, C)
  bf16* cab_out;   // (B, H, W, C)
  float* partial;  // (B, tiles, C + pdim)
  int H, W, C, MID, pdim;
  float eps;
  bool vec_x;   // 8-byte copies of x's rows
  bool vec_w1;  // 8-byte copies of w1's rows
  bool vec_w2;  // 8-byte copies of w2's rows
  bool pairs;   // ln1 and cab stored as bf16 pairs
};

// ln1, cab_mid and the tile's partial sums for the kTileY x kTileX interior
// pixels of a block. N1: n8 tiles of a conv1 job (2 or 4); NH: n8 tiles of
// half of conv2's N.
template <int N1, int NH>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mma_hab_front_kernel(FrontArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, MID = a.MID;
  const int kc = c_width(C), km = mid_width(MID);
  const int lst = kc + kPad;    // LN tile row stride (bf16)
  const int tst = km + kPad;    // t1 tile and conv1 slab row stride
  constexpr int kN2 = 16 * NH;  // conv2's N, both halves
  constexpr int w2st = kN2 + kPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileY, x0 = blockIdx.x * kTileX;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);  // LN tile, then t1 tile
  unsigned char* stages = smem_raw + a_bytes(C, MID);
  const int stage = stage_bytes(C, MID);

  // the pixel of LN position t, -1 outside the image
  auto pix_ln = [&](int t) -> long long {
    const int py = y0 - 2 + t / kLnX, px = x0 - 2 + t % kLnX;
    return py >= 0 && py < a.H && px >= 0 && px < a.W
               ? (static_cast<long long>(b) * a.H + py) * a.W + px
               : -1;
  };

  // slab s into stage s % kStages: conv1's tap s (s < 9; C rows of MID
  // columns) or conv2's tap s - 9 (MID rows of C columns), zero past them
  // to the slab's padded width; one commit group a call, empty past the last
  auto load = [&](int s) {
    if (s < kTaps) {
      bf16* dst = reinterpret_cast<bf16*>(stages + (s % kStages) * stage);
      const bf16 zero = __float2bfloat16(0.f);
      const bool conv1 = s < 9;
      const int rows = conv1 ? kc : km, cols = conv1 ? km : kN2;
      const int n_rows = conv1 ? C : MID, n_cols = conv1 ? MID : C;
      const int dst_st = conv1 ? tst : w2st;
      const bf16* src = conv1
          ? a.w1 + static_cast<long long>(s) * C * MID
          : a.w2 + static_cast<long long>(s - 9) * MID * C;
      if (conv1 ? a.vec_w1 : a.vec_w2) {
        for (DivMod e(tid, kBlockThreads, cols / 4); e.q < rows; e.next()) {
          const int r = e.q, c = 4 * e.r;
          const bool ok = r < n_rows && c < n_cols;
          mma::cp_async8(dst + r * dst_st + c,
                         ok ? src + r * n_cols + c : src, ok);
        }
      } else {
        for (int e = tid; e < rows * cols; e += kBlockThreads) {
          const int r = e / cols, c = e % cols;
          dst[r * dst_st + c] =
              r < n_rows && c < n_cols ? src[r * n_cols + c] : zero;
        }
      }
    }
    mma::cp_async_commit();
  };

  // the halo's rows of x into the LN tile, zero past C and outside the
  // image: the first commit group
  if (a.vec_x) {
    for (DivMod e(tid, kBlockThreads, kc / 4); e.q < kLnPos; e.next()) {
      const int t = e.q, c = 4 * e.r;
      const long long p = pix_ln(t);
      const bool ok = p >= 0 && c < C;
      mma::cp_async8(at + t * lst + c, ok ? a.x + p * C + c : a.x, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kLnPos * kc; e += kBlockThreads) {
      const int t = e / kc, c = e % kc;
      const long long p = pix_ln(t);
      at[t * lst + c] = p >= 0 && c < C ? a.x[p * C + c] : zero;
    }
  }
  mma::cp_async_commit();
  // conv1's first slabs while the rows are normalised
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // LN of every position inside the image, in place, rounded to bf16
  // (float32 statistics in two passes); a position outside stays zero, as
  // conv1's zero padding needs. The tile's own rows are ln1. One warp a
  // row, a lane's channel pairs 2 lane + 64 j in registers for both passes
  // and the write, gamma and beta of those channels loaded once.
  float2 gam[kLnPairs], bet[kLnPairs];
#pragma unroll
  for (int j = 0; j < kLnPairs; ++j) {
    const int c = 2 * lane + 64 * j;
    gam[j] = make_float2(c < C ? __bfloat162float(a.gamma[c]) : 0.f,
                         c + 1 < C ? __bfloat162float(a.gamma[c + 1]) : 0.f);
    bet[j] = make_float2(c < C ? __bfloat162float(a.beta[c]) : 0.f,
                         c + 1 < C ? __bfloat162float(a.beta[c + 1]) : 0.f);
  }
  mma::cp_async_wait<kStages - 1>();
  __syncthreads();
  for (int t = warp; t < kLnPos; t += kWarps) {
    const long long p = pix_ln(t);
    if (p < 0) continue;  // warp-uniform
    bf16* row = at + t * lst;
    float2 v[kLnPairs];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPairs; ++j) {
      const int c = 2 * lane + 64 * j;  // past C the row is zero
      v[j] = c < kc ? pair(row + c) : make_float2(0.f, 0.f);
      sum += v[j].x + v[j].y;
    }
    const float mu = srk::warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPairs; ++j) {
      const int c = 2 * lane + 64 * j;
      const float dx = c < C ? v[j].x - mu : 0.f;
      const float dy = c + 1 < C ? v[j].y - mu : 0.f;
      sq += dx * dx + dy * dy;
    }
    const float rstd = rsqrtf(srk::warp_sum(sq) / C + a.eps);
    const int ly = t / kLnX, lx = t % kLnX;
    const bool own = ly >= 2 && ly < kTileY + 2 && lx >= 2 && lx < kTileX + 2;
#pragma unroll
    for (int j = 0; j < kLnPairs; ++j) {
      const int c = 2 * lane + 64 * j;
      if (c >= C) continue;
      const float y0 = (v[j].x - mu) * rstd * gam[j].x + bet[j].x;
      const float y1 = (v[j].y - mu) * rstd * gam[j].y + bet[j].y;
      if (c + 1 < C) {
        const uint32_t w = mma::pack(y0, y1);
        *reinterpret_cast<uint32_t*>(row + c) = w;
        if (own && a.pairs) {
          *reinterpret_cast<uint32_t*>(a.ln_out + p * C + c) = w;
        } else if (own) {
          a.ln_out[p * C + c] = row[c];
          a.ln_out[p * C + c + 1] = row[c + 1];
        }
      } else {
        row[c] = __float2bfloat16(y0);
        if (own) a.ln_out[p * C + c] = row[c];
      }
    }
  }
  __syncthreads();

  // this tile's share of gap16, in pixel order (0 outside the image)
  float* part =
      a.partial + (static_cast<long long>(b) * gridDim.x * gridDim.y +
                   blockIdx.y * gridDim.x + blockIdx.x) * (C + a.pdim);
  for (int c = tid; c < a.pdim; c += kBlockThreads) {
    float s = 0.f;
    for (int p = 0; p < kPix; ++p)
      s += __bfloat162float(
          at[((p / kTileX + 2) * kLnX + p % kTileX + 2) * lst + c]);
    part[C + c] = s;
  }

  // conv1: a warp's job is kConv1Tiles m16 tiles of the t1 positions by
  // 8 N1 columns; a lane's ldmatrix row is its position's LN row at tap
  // (0, 0), the tap adds its offset. Rows past kT1Pos read position
  // kT1Pos - 1 and are dropped.
  const int groups1 = km / (8 * N1);
  const bool live1 = warp < kMGroups1 * groups1;
  const int mg1 = warp % kMGroups1, ng1 = warp / kMGroups1;
  const int a_col = 8 * (mi >> 1);
  int arow[kConv1Tiles];
#pragma unroll
  for (int i = 0; i < kConv1Tiles; ++i) {
    const int m = min((mg1 * kConv1Tiles + i) * 16 + 8 * (mi & 1) + r8,
                      kT1Pos - 1);
    arow[i] = (m / kT1X) * kLnX + m % kT1X;
  }
  float acc1[kConv1Tiles][N1][4];
#pragma unroll
  for (int i = 0; i < kConv1Tiles; ++i)
#pragma unroll
    for (int j = 0; j < N1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
  const int w1_off = (8 * (mi & 1) + r8) * tst + 8 * (mi >> 1) + ng1 * 8 * N1;
  for (int s = 0; s < 9; ++s) {
    // slab s has landed; every warp is past slab s - 1, whose stage slab
    // s + kStages - 1 takes
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(s + kStages - 1);
    if (!live1) continue;
    const bf16* ws =
        reinterpret_cast<const bf16*>(stages + (s % kStages) * stage);
    const int tap = (s / 3) * kLnX + s % 3;
    for (int kk = 0; kk < kc / 16; ++kk) {
      uint32_t bw[N1 / 2][4];
#pragma unroll
      for (int np = 0; np < N1 / 2; ++np)
        mma::ldsm_x4_trans(bw[np], ws + w1_off + kk * 16 * tst + np * 16);
#pragma unroll
      for (int i = 0; i < kConv1Tiles; ++i) {
        if (mg1 * kConv1Tiles + i >= kT1Tiles) continue;
        uint32_t af[4];
        mma::ldsm_x4(af, at + (arow[i] + tap) * lst + a_col + kk * 16);
#pragma unroll
        for (int np = 0; np < N1 / 2; ++np) {
          mma::mma_bf16(acc1[i][2 * np], af, bw[np][0], bw[np][1]);
          mma::mma_bf16(acc1[i][2 * np + 1], af, bw[np][2], bw[np][3]);
        }
      }
    }
  }

  // every warp is done with the LN tile: t1 = gelu(conv1 + b1) inside the
  // image, exactly 0 outside it and past MID, rounded to bf16 into the t1
  // tile (rows gid, gid + 8 of each m16 tile; columns 2 tig, + 1)
  __syncthreads();
  if (live1) {
#pragma unroll
    for (int i = 0; i < kConv1Tiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mg1 * kConv1Tiles + i) * 16 + gid + 8 * h;
        if (m >= kT1Pos) continue;
        const int py = y0 - 1 + m / kT1X, px = x0 - 1 + m % kT1X;
        const bool in = py >= 0 && py < a.H && px >= 0 && px < a.W;
#pragma unroll
        for (int j = 0; j < N1; ++j) {
          const int n = ng1 * 8 * N1 + 8 * j + 2 * tig;
          float v0 = 0.f, v1 = 0.f;
          if (in && n < MID)
            v0 = srk::gelu_as(acc1[i][j][2 * h] + __bfloat162float(a.b1[n]));
          if (in && n + 1 < MID)
            v1 = srk::gelu_as(acc1[i][j][2 * h + 1] +
                              __bfloat162float(a.b1[n + 1]));
          *reinterpret_cast<uint32_t*>(at + m * tst + n) = mma::pack(v0, v1);
        }
      }
  }

  // conv2: a warp's job is kConv2Tiles m16 tiles of interior pixels (two
  // interior rows) by half of N; a lane's ldmatrix row is its pixel's t1
  // row at tap (0, 0)
  const bool live2 = warp < 2 * kMGroups2;
  const int mg2 = warp >> 1, half = warp & 1;
  int prow[kConv2Tiles];
#pragma unroll
  for (int i = 0; i < kConv2Tiles; ++i) {
    const int p = (mg2 * kConv2Tiles + i) * 16 + 8 * (mi & 1) + r8;
    prow[i] = (p / kTileX) * kT1X + p % kTileX;
  }
  float acc2[kConv2Tiles][NH][4];
#pragma unroll
  for (int i = 0; i < kConv2Tiles; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
  const int w2_off =
      (8 * (mi & 1) + r8) * w2st + 8 * (mi >> 1) + half * 8 * NH;
  for (int s = 9; s < kTaps; ++s) {
    // the first pass also waits for the t1 tile
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    load(s + kStages - 1);
    if (!live2) continue;
    const bf16* ws =
        reinterpret_cast<const bf16*>(stages + (s % kStages) * stage);
    const int tap = ((s - 9) / 3) * kT1X + (s - 9) % 3;
    for (int kk = 0; kk < km / 16; ++kk) {
      uint32_t af[kConv2Tiles][4];
#pragma unroll
      for (int i = 0; i < kConv2Tiles; ++i)
        mma::ldsm_x4(af[i], at + (prow[i] + tap) * tst + a_col + kk * 16);
#pragma unroll
      for (int np = 0; np < NH / 2; ++np) {
        uint32_t bw[4];
        mma::ldsm_x4_trans(bw, ws + w2_off + kk * 16 * w2st + np * 16);
#pragma unroll
        for (int i = 0; i < kConv2Tiles; ++i) {
          mma::mma_bf16(acc2[i][2 * np], af[i], bw[0], bw[1]);
          mma::mma_bf16(acc2[i][2 * np + 1], af[i], bw[2], bw[3]);
        }
      }
    }
  }

  // epilogue: cab = conv2 + b2 in float32, stored rounded; the column sums
  // of the warp's pixels inside the image (its rows by gid, then over gid
  // by shuffles) into the stages, which every warp is done with
  mma::cp_async_wait<0>();
  __syncthreads();
  float* colsum = reinterpret_cast<float*>(stages);  // kMGroups2 x kN2
  if (live2) {
    long long q[kConv2Tiles][2];
#pragma unroll
    for (int i = 0; i < kConv2Tiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mg2 * kConv2Tiles + i) * 16 + gid + 8 * h;
        const int py = y0 + p / kTileX, px = x0 + p % kTileX;
        q[i][h] = py < a.H && px < a.W
                      ? (static_cast<long long>(b) * a.H + py) * a.W + px
                      : -1;
      }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int n = half * 8 * NH + 8 * j + 2 * tig;
      const float c0 = n < C ? __bfloat162float(a.b2[n]) : 0.f;
      const float c1 = n + 1 < C ? __bfloat162float(a.b2[n + 1]) : 0.f;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < kConv2Tiles; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (q[i][h] < 0) continue;
          const float v0 = acc2[i][j][2 * h] + c0;
          const float v1 = acc2[i][j][2 * h + 1] + c1;
          s0 += v0;
          s1 += v1;
          bf16* dst = a.cab_out + q[i][h] * C + n;
          if (a.pairs && n + 1 < C) {
            *reinterpret_cast<uint32_t*>(dst) = mma::pack(v0, v1);
          } else {
            if (n < C) dst[0] = __float2bfloat16(v0);
            if (n + 1 < C) dst[1] = __float2bfloat16(v1);
          }
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (gid == 0) {
        colsum[mg2 * kN2 + n] = s0;
        colsum[mg2 * kN2 + n + 1] = s1;
      }
    }
  }
  __syncthreads();
  // this tile's share of gap_cab: the warps' sums in warp order
  for (int c = tid; c < C; c += kBlockThreads) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kMGroups2; ++g) s += colsum[g * kN2 + c];
    part[c] = s;
  }
}

template <int N1, int NH>
cudaError_t launch_nt(const FrontArgs& a, dim3 grid, int smem,
                      cudaStream_t stream) {
  cudaError_t err = srk::set_smem(mma_hab_front_kernel<N1, NH>, smem);
  if (err != cudaSuccess) return err;
  mma_hab_front_kernel<N1, NH><<<grid, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_hab_front_smem(int dtype, int C, int MID) {
  return static_cast<int>(smem_bytes(dtype, C, MID));
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_hab_front's. x (B, H, W, C); gamma, beta, b2 (C,); w1 (3, 3, C,
// MID), b1 (MID,); w2 (3, 3, MID, C); ln_out, cab_out (B, H, W, C);
// partial: float32 scratch of B * ceil(H / 8) * ceil(W / 8) * (C + pdim)
// elements; gap_cab (B, C) and gap16 (B, pdim) float32. Returns the
// cudaError_t of the launches.
extern "C" int sr_hab_front(int dtype, const void* x, const void* gamma,
                            const void* beta, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* ln_out,
                            void* cab_out, void* partial, void* gap_cab,
                            void* gap16, int B, int H, int W, int C, int MID,
                            int pdim, float eps, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch<float>(dtype, x, gamma, beta, w1, b1, w2, b2, ln_out, cab_out,
                       static_cast<float*>(partial),
                       static_cast<float*>(gap_cab),
                       static_cast<float*>(gap16), B, H, W, C, MID, pdim, eps,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the tensor-core kernel needs at
// C channels and a conv1 width of MID; the wrapper holds this against the
// card's limit before it launches.
extern "C" int sr_mma_hab_front_smem(int C, int MID) {
  return tc::smem_bytes(C, MID);
}

// The HAB front in bf16 on the tensor cores: operands as sr_hab_front's,
// all bf16 but the float32 partial sums and results; C up to tc::kMaxC and
// MID up to tc::kMaxMid; partial holds B * ceil(H / 8) * ceil(W / 16) *
// (C + pdim) floats. Returns the cudaError_t of the launches.
extern "C" int sr_mma_hab_front(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* ln_out, void* cab_out,
                                void* partial, void* gap_cab, void* gap16,
                                int B, int H, int W, int C, int MID, int pdim,
                                float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || C > tc::kMaxC ||
      MID < 1 || MID > tc::kMaxMid || pdim < 0 || pdim > C)
    return cudaErrorInvalidValue;
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto aligned = [](const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  tc::FrontArgs a;
  a.x = b16(x);
  a.gamma = b16(gamma);
  a.beta = b16(beta);
  a.w1 = b16(w1);
  a.b1 = b16(b1);
  a.w2 = b16(w2);
  a.b2 = b16(b2);
  a.ln_out = static_cast<bf16*>(ln_out);
  a.cab_out = static_cast<bf16*>(cab_out);
  a.partial = static_cast<float*>(partial);
  a.H = H;
  a.W = W;
  a.C = C;
  a.MID = MID;
  a.pdim = pdim;
  a.eps = eps;
  a.vec_x = C % 4 == 0 && aligned(x, 8);
  a.vec_w1 = MID % 4 == 0 && aligned(w1, 8);
  a.vec_w2 = C % 4 == 0 && aligned(w2, 8);
  a.pairs = C % 2 == 0 && aligned(cab_out, 4) && aligned(ln_out, 4);
  const dim3 grid((W + tc::kTileX - 1) / tc::kTileX,
                  (H + tc::kTileY - 1) / tc::kTileY, B);
  const int smem = tc::smem_bytes(C, MID);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // conv1 in jobs of 32 columns (16 where MID is at most 16); conv2's
  // halves of 96 columns up to C 192, of 128 above
  const bool wide = tc::mid_width(MID) > 16;
  cudaError_t err =
      tc::nh_of(C) == 12
          ? (wide ? tc::launch_nt<4, 12>(a, grid, smem, st)
                  : tc::launch_nt<2, 12>(a, grid, smem, st))
          : (wide ? tc::launch_nt<4, 16>(a, grid, smem, st)
                  : tc::launch_nt<2, 16>(a, grid, smem, st));
  if (err != cudaSuccess) return err;
  const int n = B * (C + pdim);
  hab_front_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<float*>(partial), static_cast<float*>(gap_cab),
      static_cast<float*>(gap16), B, grid.x * grid.y, C, pdim);
  return cudaGetLastError();
}
