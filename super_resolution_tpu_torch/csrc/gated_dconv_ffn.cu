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
// at :124, body _ffn_kernel :34-98). The depthwise conv pads ITS INPUT with
// zeros: a neighbour outside the image contributes 0, not fc1(LN(0)) = b1.
//
// What bounds it on the H100: at the flagship shape (C 180, M 360) the two
// products are 2 * 180 * 720 + 2 * 360 * 180 = 389 kFLOP per pixel against
// 720 bytes of bf16 traffic: 540 FLOP/byte, compute-bound even on the
// tensor cores: 39.8 GFLOP at the flagship chunk of four 160 x 160 tiles,
// 0.040 ms at 989 TFLOP/s.
//
// In bf16 it is mma_gated_dconv_ffn_kernel (namespace tc), both products on
// the tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums). A
// block of kWarps = 8 warps takes an 8 x 16 interior tile, an interior row
// a warp, and its one-pixel halo (10 x 18 = 180 positions, 192 rows with
// the pad to m16 tiles: fc1 runs 1.5x per pixel, 1.41x without the pad,
// against the first version's 1.56x on 8 x 8 tiles):
//   prologue  the halo's rows of x into an A tile by cp.async, zero past C,
//             outside the image and past 180; LN in place, one warp a row
//             (float32 statistics in two passes), rounded to bf16; a column
//             of ones after C that is 0 outside the image, so that fc1 adds
//             b1 (W1's stage holds it in row C) inside the image and leaves
//             h = 0 outside it, as the conv's zero padding needs; the
//             accumulators start at b2 (+ x) of the warp's 16 pixels;
//   panels    of kPanelCh = 32 proj channels beside their 32 gate partners,
//             whose W1 columns, W2 rows and depthwise taps with bd come
//             through kStages = 2 shared-memory stages by cp.async, the
//             next panel's in flight: fc1 of the 64 columns over the 192
//             rows (a warp takes 3 m16 tiles of one half, proj or gate, and
//             loads each W1 fragment once for them), rounded to bf16 into
//             an h tile; after a block barrier each warp forms its fc2 A
//             fragments straight from the h tile: the 3 x 3 depthwise of its
//             16 pixels in float32 + bd, the gate, rounded to bf16 (the
//             A layout of m16k16: rows gid, gid + 8, channels 2 tig, + 1 and
//             8 on); fc2 of the panel's W2 rows into C_out-wide float32
//             accumulators (NT n8 tiles, C_out rounded up to 64, a template
//             argument), in mma_mlp_tail_kernel's layout;
//   epilogue  the accumulators rounded once, staged through shared memory
//             and written as whole runs of the warp's image row, cut at the
//             image's edge (mma_proj.cuh's write_rows).
// Shared memory (tc::smem_bytes, twin cuda_ffn.mma_gated_ffn_smem): the A
// tile, the h tile and two stages, whatever M: 187,904 bytes at C 180,
// 166,400 at HAT-S's C 144. The accumulators (4 NT a lane) allow one block
// an SM, as in the tail. The panel and fc1's grouping were chosen side by
// side (tools/gated_ffn_variants.py, an H100 at 700 W, the flagship chunk
// of four 160 x 160 tiles): 0.717 ms as kept, 0.760 with panels of 16
// channels (panels of 48 do not fit at C 180), 0.782 with fc1 one m16
// tile at a time; without fc1 0.591, without the depthwise 0.564, without
// the weight copies 0.604. The stage count was not varied.
//
// In float32 it is gated_dconv_ffn_kernel below, the first version and the
// exact check on the card; its entry refuses bf16. The TPU kernel keeps
// fc1's output for a band of full rows in fast memory; a (rows + 2, W + 2,
// 2M) band does not fit a block's shared memory here. The conv is
// depthwise, so the work is tiled in space AND over channels: one block
// takes a kTile x kTile pixel tile with a one-pixel halo (kPos = (kTile +
// 2)^2 positions). It forms LN once for all positions, then loops over
// chunks of kChunk "proj" channels [j, j + kChunk) with their gate partners
// [M + j, M + j + kChunk): fc1 for those 2 kChunk columns on every position
// (zero where the position is outside the image), the 3x3 depthwise conv
// and the gate on the interior pixels, and that chunk's share of fc2 added
// into a float32 output tile in shared memory, all as float32 FMA loops on
// the CUDA cores. Nothing but x and out touches device memory. fc1 runs on
// 100 positions for 64 pixels, 1.56x the work. Shared memory per block at
// the flagship shape: 156 kB.
#include <stdint.h>

#include "common.cuh"
#include "mma_proj.cuh"

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

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // warps of a block, one interior row each
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kTileY = kWarps;  // interior rows of a block
constexpr int kTileX = 16;      // interior columns: a warp's 16 pixels
constexpr int kHaloX = kTileX + 2;
constexpr int kPos = (kTileY + 2) * kHaloX;      // 180 halo positions
constexpr int kPosRows = (kPos + 15) / 16 * 16;  // 192: fc1's m16 tiles
constexpr int kPanelCh = 32;  // proj channels of a panel, beside their gates
constexpr int kCols = 2 * kPanelCh;                   // fc1 columns a panel
constexpr int kColStride = kCols + mma::kProjPad;   // W1 stage, h tile rows
constexpr int kStages = 2;     // weight stages: the next panel's in flight
constexpr int kFc1Tiles = 3;   // fc1's m16 tiles a warp holds at once
constexpr int kMaxOut = 256;   // the widest cout the accumulators hold
// fc1: the halo's m16 tiles in two column halves (proj, gate), 3 tiles
// each for 4 warps a half
static_assert(kPosRows == 16 * 3 * kWarps / 2, "3 m16 tiles a warp");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Columns of the A tile: C and the ones column that adds b1 in fc1,
// rounded up to 16, zero past them.
__host__ __device__ constexpr int k_width(int c) { return (c + 16) / 16 * 16; }

// Row stride (bf16) of the A tile: the width plus the pad that puts the 8
// rows of an ldmatrix in distinct banks.
__host__ __device__ constexpr int a_stride(int c) {
  return k_width(c) + mma::kProjPad;
}

// Accumulator columns for cout: cout rounded up to 64 (8 NT).
__host__ __device__ constexpr int out_width(int n) {
  return (n + 63) / 64 * 64;
}

// Bytes of a stage: a panel's W1 columns (b1 in row C; k_width rows of
// kColStride), its W2 rows (kPanelCh rows of the padded output width) and
// its depthwise taps with bd (10 rows of kCols).
__host__ __device__ constexpr int stage_bytes(int c, int n) {
  return 2 * (k_width(c) * kColStride +
              kPanelCh * (out_width(n) + mma::kProjPad) + 10 * kCols);
}

// The A tile, the h tile and kStages stages, which the epilogue's staged
// output tiles (a warp's 16 rows of kRowsStride) reuse.
__host__ __device__ constexpr int smem_bytes(int c, int n) {
  return 2 * kPosRows * a_stride(c) + 2 * kPosRows * kColStride +
         cmax(kStages * stage_bytes(c, n),
              kWarps * 16 * mma::kRowsStride * 2);
}

struct FfnArgs {
  const bf16* x;  // (B, H, W, C)
  const bf16* gamma;
  const bf16* beta;
  const bf16* w1;  // (C, 2M)
  const bf16* b1;
  const bf16* wd;  // (3, 3, 2M)
  const bf16* bd;
  const bf16* w2;  // (M, cout)
  const bf16* b2;
  mma::RowsOut out;  // (B H W, cout)
  int H, W, C, M, cout, ln, residual;
  float eps;
  bool vec_x;   // 8-byte copies of x's rows
  bool pairs;   // x read as bf16 pairs for the residual
  bool vec_w;   // 16-byte copies of a panel's W1, b1, wd, bd columns
  bool vec_w2;  // 8-byte copies of W2's rows
};

// A 4-byte aligned bf16 pair as floats.
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// out = round(fc2(gate(dw3x3(fc1(LN(x))))) + b2 (+ x)) for the kTileY x
// kTileX interior pixels of a block, cout up to 8 NT: out_width(cout) ==
// 8 NT.
template <int NT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mma_gated_dconv_ffn_kernel(FfnArgs a) {
  constexpr int kWo = 8 * NT, kOst = kWo + mma::kProjPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, M = a.M, n_out = a.cout;
  const int kw = k_width(C), ast = kw + mma::kProjPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileY, x0 = blockIdx.x * kTileX;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);  // kPosRows x ast
  bf16* hs = at + kPosRows * ast;                // kPosRows x kColStride
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      hs + kPosRows * kColStride);
  const int w1_bytes = 2 * kw * kColStride;
  const int stage = w1_bytes + 2 * (kPanelCh * kOst + 10 * kCols);
  const int panels = (M + kPanelCh - 1) / kPanelCh;
  const long long m2 = 2 * static_cast<long long>(M);

  // the pixel of halo position t, -1 outside the image (and past kPos)
  auto pix_of = [&](int t) -> long long {
    const int py = y0 - 1 + t / kHaloX, px = x0 - 1 + t % kHaloX;
    return t < kPos && py >= 0 && py < a.H && px >= 0 && px < a.W
               ? (static_cast<long long>(b) * a.H + py) * a.W + px
               : -1;
  };

  // panel p's W1 columns (proj channels p kPanelCh .., then their gate
  // partners M + p kPanelCh ..; b1 in row C), its W2 rows and its taps and
  // bd into stage st, zero past M, C and cout; one commit group a call,
  // empty past the last panel
  auto load = [&](int p, int st) {
    if (p < panels) {
      const int j0 = p * kPanelCh;
      bf16* d1 = reinterpret_cast<bf16*>(stages + st * stage);
      bf16* d2 = reinterpret_cast<bf16*>(stages + st * stage + w1_bytes);
      bf16* d3 = d2 + kPanelCh * kOst;
      const bf16 zero = __float2bfloat16(0.f);
      // the W1 (or taps) column of panel column c
      auto col = [&](int c) {
        return c < kPanelCh ? j0 + c : M + j0 + c - kPanelCh;
      };
      if (a.vec_w) {
        // 16-byte pieces, kCols / 8 a row
        for (int e = tid; e < (kw + 10) * (kCols / 8); e += kBlockThreads) {
          const int r = e / (kCols / 8), c = (e % (kCols / 8)) * 8;
          const bool ok = j0 + c % kPanelCh < M && (r >= kw || r <= C);
          const bf16* src = r >= kw ? (r - kw < 9 ? a.wd + (r - kw) * m2
                                                  : a.bd)
                            : r < C ? a.w1 + r * m2
                                    : a.b1;
          bf16* dst = r >= kw ? d3 + (r - kw) * kCols + c
                              : d1 + r * kColStride + c;
          mma::cp_async16(dst, ok ? src + col(c) : a.w1, ok);
        }
      } else {
        for (int e = tid; e < (kw + 10) * kCols; e += kBlockThreads) {
          const int r = e / kCols, c = e % kCols;
          const bool ok = j0 + c % kPanelCh < M && (r >= kw || r <= C);
          const bf16* src = r >= kw ? (r - kw < 9 ? a.wd + (r - kw) * m2
                                                  : a.bd)
                            : r < C ? a.w1 + r * m2
                                    : a.b1;
          bf16* dst = r >= kw ? d3 + (r - kw) * kCols + c
                              : d1 + r * kColStride + c;
          *dst = ok ? src[col(c)] : zero;
        }
      }
      // W2: the panel's rows, 8-byte pieces
      for (int e = tid; e < kPanelCh * (kWo / 4); e += kBlockThreads) {
        const int r = e / (kWo / 4), c = (e % (kWo / 4)) * 4;
        const bf16* src = a.w2 + static_cast<long long>(j0 + r) * n_out + c;
        if (a.vec_w2) {
          const bool ok = j0 + r < M && c < n_out;
          mma::cp_async8(d2 + r * kOst + c, ok ? src : a.w2, ok);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            d2[r * kOst + c + u] =
                j0 + r < M && c + u < n_out ? src[u] : zero;
        }
      }
    }
    mma::cp_async_commit();
  };

  // the halo's rows of x into the A tile, zero past C, outside the image
  // and past kPos: the first commit group
  if (a.vec_x) {
    for (int e = tid; e < kPosRows * (kw / 4); e += kBlockThreads) {
      const int t = e / (kw / 4), c = (e % (kw / 4)) * 4;
      const long long p = pix_of(t);
      const bool ok = p >= 0 && c < C;
      mma::cp_async8(at + t * ast + c, ok ? a.x + p * C + c : a.x, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kPosRows * kw; e += kBlockThreads) {
      const int t = e / kw, c = e % kw;
      const long long p = pix_of(t);
      at[t * ast + c] = p >= 0 && c < C ? a.x[p * C + c] : zero;
    }
  }
  mma::cp_async_commit();
  load(0, 0);  // panel 0's weights while the rows are normalised

  // the accumulators start at b2 (+ x) of the warp's 16 pixels (row y0 +
  // warp, columns x0 ..): rows gid, gid + 8, columns 8j + 2 tig, + 1
  float acc[NT][4];
  {
    const int py = y0 + warp;
    const bf16* row[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + gid + 8 * h;
      live[h] = a.residual && py < a.H && px < a.W;
      row[h] = a.x + (live[h] ? ((static_cast<long long>(b) * a.H + py) *
                                     a.W + px) * C
                              : 0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * tig;
      const float c0 = c < n_out ? __bfloat162float(a.b2[c]) : 0.f;
      const float c1 = c + 1 < n_out ? __bfloat162float(a.b2[c + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = make_float2(0.f, 0.f);
        if (live[h] && a.pairs && c < n_out) {
          v = pair(row[h] + c);  // global: a bf16 pair, 4-byte aligned
        } else {
          if (live[h] && c < n_out) v.x = __bfloat162float(row[h][c]);
          if (live[h] && c + 1 < n_out) v.y = __bfloat162float(row[h][c + 1]);
        }
        acc[j][2 * h] = v.x + c0;
        acc[j][2 * h + 1] = v.y + c1;
      }
    }
  }

  // LN(x) of every halo position inside the image, in place, rounded to
  // bf16 (float32 statistics in two passes), and the ones column: 1 inside
  // the image, 0 outside, where the row stays zero, so that fc1 there is
  // 0 and not b1: the conv pads its input with zeros
  mma::cp_async_wait<1>();
  __syncthreads();
  for (int t = warp; t < kPos; t += kWarps) {
    bf16* row = at + t * ast;
    const bool inside = pix_of(t) >= 0;
    if (inside && a.ln) {
      float mu, rstd;
      srk::warp_ln_stats([&](int c) { return __bfloat162float(row[c]); }, C,
                         a.eps, mu, rstd);
      for (int c = lane; c < C; c += 32)
        row[c] = __float2bfloat16(
            (__bfloat162float(row[c]) - mu) * rstd *
                __bfloat162float(a.gamma[c]) +
            __bfloat162float(a.beta[c]));
    }
    if (lane == 0) row[C] = __float2bfloat16(inside ? 1.f : 0.f);
  }

  // fc1: the warp's 3 m16 tiles of the halo (mt0 ..), columns of its half
  // of the panel (proj or gate)
  const int half = warp & 1, mt0 = (warp >> 1) * 3;
  const int a_off = (8 * (mi & 1) + r8) * ast + 8 * (mi >> 1);
  const int w_off = (8 * (mi & 1) + r8) * kColStride + 8 * (mi >> 1);
  const int w2_off = (8 * (mi & 1) + r8) * kOst + 8 * (mi >> 1);
  for (int p = 0; p < panels; ++p) {
    // panel p's copies have landed; every warp is past panel p - 1, whose
    // stage the copies of panel p + 1 take and whose h tile fc1 rewrites
    mma::cp_async_wait<0>();
    __syncthreads();
    load(p + 1, (p + 1) % kStages);
    const unsigned char* stg = stages + (p % kStages) * stage;
    const bf16* w1s = reinterpret_cast<const bf16*>(stg) + half * kPanelCh;
    const bf16* w2s = reinterpret_cast<const bf16*>(stg + w1_bytes);
    const bf16* taps = w2s + kPanelCh * kOst;
    // h = round(LN(x) W1 + b1), b1 by the ones column, into the h tile
#pragma unroll
    for (int u = 0; u < 3 / kFc1Tiles; ++u) {
      float hacc[kFc1Tiles][kPanelCh / 8][4];
#pragma unroll
      for (int i = 0; i < kFc1Tiles; ++i)
#pragma unroll
        for (int j = 0; j < kPanelCh / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.f;
      const int mt = mt0 + u * kFc1Tiles;
      for (int kk = 0; kk < kw / 16; ++kk) {
        uint32_t bw[kPanelCh / 16][4];
#pragma unroll
        for (int np = 0; np < kPanelCh / 16; ++np)
          mma::ldsm_x4_trans(bw[np], w1s + w_off + kk * 16 * kColStride +
                                         np * 16);
#pragma unroll
        for (int i = 0; i < kFc1Tiles; ++i) {
          uint32_t af[4];
          mma::ldsm_x4(af, at + (mt + i) * 16 * ast + a_off + kk * 16);
#pragma unroll
          for (int np = 0; np < kPanelCh / 16; ++np) {
            mma::mma_bf16(hacc[i][2 * np], af, bw[np][0], bw[np][1]);
            mma::mma_bf16(hacc[i][2 * np + 1], af, bw[np][2], bw[np][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFc1Tiles; ++i)
#pragma unroll
        for (int j = 0; j < kPanelCh / 8; ++j) {
          uint32_t* h0 = reinterpret_cast<uint32_t*>(
              hs + ((mt + i) * 16 + gid) * kColStride + half * kPanelCh +
              8 * j + 2 * tig);
          h0[0] = mma::pack(hacc[i][j][0], hacc[i][j][1]);
          h0[8 * kColStride / 2] = mma::pack(hacc[i][j][2], hacc[i][j][3]);
        }
    }
    __syncthreads();
    // the depthwise 3 x 3 of h over the warp's 16 pixels in float32, + bd,
    // the gate d[:M] * sigmoid(d[M:]) * d[M:], rounded to bf16 straight
    // into fc2's A fragments (rows gid, gid + 8; channels 2 tig, + 1 and
    // 8 on of a 16-deep step), then fc2 with the panel's W2 rows into the
    // C-wide accumulators
#pragma unroll
    for (int q = 0; q < kPanelCh / 16; ++q) {
      uint32_t gf[4];
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const int c = 16 * q + 8 * cg + 2 * tig;  // its gate at c + kPanelCh
        float2 dp[2], dg[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dp[h] = make_float2(0.f, 0.f);
          dg[h] = make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float2 wp = pair(taps + (3 * dy + dx) * kCols + c);
            const float2 wg =
                pair(taps + (3 * dy + dx) * kCols + kPanelCh + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bf16* hr =
                  hs + ((warp + dy) * kHaloX + gid + 8 * h + dx) * kColStride;
              const float2 hp = pair(hr + c), hg = pair(hr + kPanelCh + c);
              dp[h].x = fmaf(hp.x, wp.x, dp[h].x);
              dp[h].y = fmaf(hp.y, wp.y, dp[h].y);
              dg[h].x = fmaf(hg.x, wg.x, dg[h].x);
              dg[h].y = fmaf(hg.y, wg.y, dg[h].y);
            }
          }
        const float2 bp = pair(taps + 9 * kCols + c);
        const float2 bg = pair(taps + 9 * kCols + kPanelCh + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = dp[h].x + bp.x, p1 = dp[h].y + bp.y;
          const float g0 = dg[h].x + bg.x, g1 = dg[h].y + bg.y;
          const float s0 = __fdividef(1.f, 1.f + __expf(-g0));
          const float s1 = __fdividef(1.f, 1.f + __expf(-g1));
          gf[h + 2 * cg] = mma::pack(p0 * s0 * g0, p1 * s1 * g1);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bw[4];
        mma::ldsm_x4_trans(bw, w2s + w2_off + 16 * q * kOst + np * 16);
        mma::mma_bf16(acc[2 * np], gf, bw[0], bw[1]);
        mma::mma_bf16(acc[2 * np + 1], gf, bw[2], bw[3]);
      }
    }
  }

  // epilogue: panels of mma::kPanel output channels through the warp's staged
  // tile, in the stages every warp is done with; the warp's pixels are
  // one run of its image row, cut at the image's edge
  mma::cp_async_wait<0>();
  __syncthreads();
  bf16* tile = reinterpret_cast<bf16*>(stages) + warp * 16 * mma::kRowsStride;
  const int py = y0 + warp;
  mma::RowsOut dst = a.out;
  dst.row0 = (static_cast<long long>(b) * a.H + py) * a.W + x0;
  dst.m = py < a.H ? dst.row0 + min(kTileX, a.W - x0) : dst.row0;
  static_assert(kWo % mma::kPanel == 0, "whole panels");
#pragma unroll
  for (int pn = 0; pn < kWo / mma::kPanel; ++pn) {
#pragma unroll
    for (int jj = 0; jj < mma::kPanel / 8; ++jj) {
      const int j = pn * (mma::kPanel / 8) + jj;
      uint32_t* t0 = reinterpret_cast<uint32_t*>(
          tile + gid * mma::kRowsStride + jj * 8 + 2 * tig);
      t0[0] = mma::pack(acc[j][0], acc[j][1]);
      t0[8 * mma::kRowsStride / 2] = mma::pack(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    // out_width(cout) - 64 < cout: every panel holds channels
    mma::write_rows(tile, dst, 0, pn * mma::kPanel,
                    min(mma::kPanel, n_out - pn * mma::kPanel), n_out);
    __syncwarp();
  }
}

template <int NT>
cudaError_t launch_nt(const FfnArgs& a, dim3 grid, int smem,
                      cudaStream_t stream) {
  cudaError_t err = srk::set_smem(mma_gated_dconv_ffn_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  mma_gated_dconv_ffn_kernel<NT><<<grid, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Bytes of dynamic shared memory one block of the FMA kernel needs; the
// wrapper holds this against the card's limit before it launches.
extern "C" int sr_gated_dconv_ffn_smem(int dtype, int C, int cout) {
  return static_cast<int>(smem_bytes(dtype, C, cout));
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_gated_dconv_ffn's. x (B, H, W, C); w1 (C, 2M); wd (3, 3, 2M); w2
// (M, cout); out (B, H, W, cout). gamma and beta are read only when ln !=
// 0. Returns the cudaError_t of the launch.
extern "C" int sr_gated_dconv_ffn(int dtype, const void* x, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* wd,
                                  const void* bd, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int C, int M, int cout, int ln,
                                  int residual, float eps, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch<float>(dtype, x, gamma, beta, w1, b1, wd, bd, w2, b2, out, B,
                       H, W, C, M, cout, ln, residual, eps,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the tensor-core kernel needs
// at C input and cout output channels, whatever M; the wrapper holds this
// against the card's limit before it launches.
extern "C" int sr_mma_gated_dconv_ffn_smem(int C, int cout) {
  return tc::smem_bytes(C, cout);
}

// The gated FFN in bf16 on the tensor cores: operands as
// sr_gated_dconv_ffn's, all bf16; cout up to tc::kMaxOut. Returns the
// cudaError_t of the launch.
extern "C" int sr_mma_gated_dconv_ffn(const void* x, const void* gamma,
                                      const void* beta, const void* w1,
                                      const void* b1, const void* wd,
                                      const void* bd, const void* w2,
                                      const void* b2, void* out, int B,
                                      int H, int W, int C, int M, int cout,
                                      int ln, int residual, float eps,
                                      void* stream) {
  using bf16 = __nv_bfloat16;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || M < 1 || cout < 1 ||
      cout > tc::kMaxOut || (residual && cout != C) ||
      (ln && (gamma == nullptr || beta == nullptr)))
    return cudaErrorInvalidValue;
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto aligned = [](const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  tc::FfnArgs a;
  a.x = b16(x);
  a.gamma = b16(gamma);
  a.beta = b16(beta);
  a.w1 = b16(w1);
  a.b1 = b16(b1);
  a.wd = b16(wd);
  a.bd = b16(bd);
  a.w2 = b16(w2);
  a.b2 = b16(b2);
  a.out = srk::mma::rows_out(out, static_cast<long long>(B) * H * W, cout);
  a.H = H;
  a.W = W;
  a.C = C;
  a.M = M;
  a.cout = cout;
  a.ln = ln;
  a.residual = residual;
  a.eps = eps;
  a.vec_x = C % 4 == 0 && aligned(x, 8);
  a.pairs = C % 2 == 0 && aligned(x, 4);
  // a panel's columns of W1, b1, wd and bd in 16-byte pieces where M is a
  // multiple of 8; W2's rows in 8-byte pieces where cout is one of 4
  a.vec_w = M % 8 == 0 && aligned(w1, 16) && aligned(b1, 16) &&
            aligned(wd, 16) && aligned(bd, 16);
  a.vec_w2 = cout % 4 == 0 && aligned(w2, 8);
  const dim3 grid((W + tc::kTileX - 1) / tc::kTileX,
                  (H + tc::kTileY - 1) / tc::kTileY, B);
  const int smem = tc::smem_bytes(C, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::out_width(cout)) {
    case 64:
      return tc::launch_nt<8>(a, grid, smem, st);
    case 128:
      return tc::launch_nt<16>(a, grid, smem, st);
    case 192:
      return tc::launch_nt<24>(a, grid, smem, st);
    default:
      return tc::launch_nt<32>(a, grid, smem, st);
  }
}
