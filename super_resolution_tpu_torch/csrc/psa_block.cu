// SRFormer's permuted self-attention block with its q and output
// projections: per ws x ws window of x (B, H, W, C)
//
//   q = round(x W_q + b_q)                                (N x C, N = ws^2)
//   o_h = softmax(q_h k_h^T * scale + bias_h + mask_w) v_h per head, against
//         the window's compressed keys and values kv (nk x 2C, nk = N / 4,
//         channels [K (C) | V (C)], heads as slices of d = C / heads)
//   out = round(concat_h o_h) W_proj + b_proj, written in image layout
//   bias (heads, N, nk) float32; mask (nW, N, nk) float32 indexed by the
//   window's position in its image, or (1, N, nk), or none.
//
// Replaces the TPU kernel fused_psa_block of
// super_resolution_tpu/ops/pallas_attention.py (pallas_call at :1282, body
// _psa_block_kernel :1199-1234). The cast points are its own: q to the
// input dtype after the bias, p to the input dtype before P @ V (p
// normalised first: an exact softmax), the head concat to the input dtype
// before the projection; every sum is float32. The kv projection and its
// 2 x 2 fold stay with the caller, as there.
//
// What bounds it on the H100: at SRFormer's chunk (four 144 x 144 tiles,
// 144 windows of N 576 against nk 144, C 180, 6 heads of d 30) a window is
// 2 * 2 * 576 * 180 * 180 = 75 MFLOP of projections and 4 * 576 * 144 * 180
// = 60 MFLOP of attention against 415 kB of bf16 x and out, 104 kB of kv
// and a 2 MB float32 bias that all windows share: 19 GFLOP (0.020 ms at the
// tensor cores' bf16 peak) against 77 MB, 89 MB with the shift mask (0.023
// and 0.026 ms at the HBM rate), and 71.7 M exponentials (0.018 ms on the
// special-function units). The bias and mask tiles every block reads
// through the L2 outweigh all of it: 0.57 GB a pass over the keys.
//
// In bf16 it is mma_psa_block_kernel, every product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, float32 sums). A block of four warps
// owns (window, 64 query rows), windows fastest in the grid, and walks the
// heads; a warp owns 16 rows from x to out, so q, the head concat and the
// rows' softmax never leave it:
//   q projection  x W_q in panels of 64 output columns, each summed over
//                 slabs of 64 input rows of x and W_q staged together
//                 (8-byte cp.async: x rows are 360 bytes apart); the result
//                 + b_q is rounded into the q tile (64 x C bf16, the x
//                 width rounded up to 16, zero past C);
//   attention     per head an exact softmax in two passes over chunks of 48
//                 keys (144 = 3 x 48): pass 1 stages the float32 bias and
//                 mask tiles and k (4-byte cp.async: head slices start
//                 every 60 bytes) and keeps each row's maximum and
//                 denominator; pass 2 stages them again with v and
//                 accumulates P V with p = exp(s - m) / l rounded to bf16
//                 (mma_attention.cuh's stats_step and normalised_step). A
//                 warp adds the staged mask into its 16 rows of the bias
//                 tile before it reads them, so the scores see one float32
//                 term, bias + mask.
//                 The head's output, rounded, overwrites its own q columns
//                 in the q tile, which its q fragments have left: the tile
//                 ends as the head concat;
//   output        concat W_proj like the q projection, from the q tile,
//                 + b_proj, rounded once into the image.
// Every step's copies are in flight while the step before is computed
// (two stages, which the three phases lay out each their own way). Shared
// memory at SRFormer's shape: 98 kB, two blocks an SM; it grows with C only
// through the q tile, so the kernel takes every shape the FMA kernel does.
// Blocks of 64 rows beat blocks of 32 (two warps) at both SRFormer shapes
// on an H100 (PERF.md section 6). Where C % 4 != 0 or d is odd the copies
// are plain loads, and the bias and mask likewise where nk % 4 != 0.
//
// In float32 it is the FMA kernel below, the exact check of the algorithm
// on the card; its entry refuses bf16. Design: one block per (window, 16
// query rows). A block keeps its 16 rows of x (then of the head concat), q
// split by head and padded to 16 or 32 columns, one head's k and v, a 16 x
// nk score tile and the reduction space: 87 kB at SRFormer's shape, two
// blocks an SM. The weights come from the L2 in slabs of 32 input rows,
// staged through the score tile's and the reduction space's memory, which
// are idle during a projection; each thread keeps a 4 x 3 piece of the 16 x
// C result in registers across the slabs. Windows are fastest in the grid,
// so blocks that run together read the same rows of the bias.
#include <stdint.h>

#include "attention_tiles.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kQT = 16;      // query rows of a block
constexpr int kSlab = 32;    // weight rows staged at a time
constexpr int kTM = 4, kTN = 3;  // outputs a thread owns in a projection

int pad_of(int d) { return d <= 16 ? 16 : 32; }

// floats the attention tile and a weight slab need; they share one region
__host__ __device__ inline int work_floats(int nk, int dp, int C) {
  const int attn = kQT * srk::score_stride(nk) + srk::kTileWarps * kQT * dp;
  const int slab = kSlab * C;
  return attn > slab ? attn : slab;
}

size_t smem_bytes(int nk, int dp, int C, int heads) {
  return sizeof(float) * (kQT * C + heads * kQT * dp +
                          2 * srk::round_up4(nk) * dp +
                          work_floats(nk, dp, C));
}

// slab[e] = w[e] for e < n. A slab is contiguous in the weight: where it
// starts on a 16-byte boundary a thread takes 16 bytes a load, so the block
// has the whole slab in flight in two or three loads a thread.
__device__ __forceinline__ void stage_slab(float* slab,
                                           const float* __restrict__ w,
                                           int n) {
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(w) & 15ull) == 0) {
    const float4* src = reinterpret_cast<const float4*>(w);
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      reinterpret_cast<float4*>(slab)[e] = src[e];
    done = n / 4 * 4;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) slab[e] = w[e];
}

// epi(m, n, sum_k a[m * C + k] * w[k * C + n]) for the kQT x C tile a in
// shared memory and the (C, C) weight w in device memory, staged through
// slab (kSlab x C floats). The last slab ends with a block barrier, so a
// and slab may be overwritten right after; what epi writes is not covered
// by it.
template <typename FE>
__device__ __forceinline__ void project_tile(const float* a,
                                             const float* __restrict__ w,
                                             int C, float* slab, FE epi) {
  const int tiles_n = (C + kTN - 1) / kTN;
  const int tiles = (kQT / kTM) * tiles_n;
  for (int t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool active = t < tiles;
    const int m0 = active ? (t / tiles_n) * kTM : 0;
    const int n0 = active ? (t % tiles_n) * kTN : 0;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kSlab) {
      const int ks = min(kSlab, C - k0);
      stage_slab(slab, w + static_cast<long long>(k0) * C, ks * C);
      __syncthreads();
      if (active) {
        for (int k = 0; k < ks; ++k) {
          float av[kTM], bv[kTN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a[(m0 + i) * C + k0 + k];
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            bv[j] = (n0 + j < C) ? slab[k * C + n0 + j] : 0.f;
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (n0 + j < C) epi(m0 + i, n0 + j, acc[i][j]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    psa_block_kernel(const float* __restrict__ x,
                     const float* __restrict__ w_q,
                     const float* __restrict__ b_q,
                     const float* __restrict__ w_proj,
                     const float* __restrict__ b_proj,
                     const float* __restrict__ kv,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, int n_mask,
                     float* __restrict__ out, int windows, int H, int W,
                     int C, int heads, int ws, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = ws * ws;
  const int nk = n / 4;
  const int nk4 = srk::round_up4(nk);
  const int d = C / heads;
  const int widx = blockIdx.x % windows;
  const int q0 = (blockIdx.x / windows) * kQT;
  const int qt = min(kQT, n - q0);
  const srk::Window win = srk::window_of(widx, H, W, ws);

  float* xo = smem;                        // kQT x C: x rows, then the concat
  float* qs = xo + kQT * C;                // heads x kQT x DP
  float* ks = qs + heads * kQT * DP;       // nk4 x DP
  float* vs = ks + nk4 * DP;               // nk4 x DP
  float* work = vs + nk4 * DP;             // score tile + reduction | slab
  float* sc = work;
  float* red = sc + kQT * srk::score_stride(nk);

  // the block's rows of x, eight threads a row; rows past the window and
  // the padding columns of q are zero
  for (int e = threadIdx.x; e < kQT * 8; e += blockDim.x) {
    const int i = e >> 3;
    const float* p = i < qt ? x + win.pixel(q0 + i) * C : nullptr;
#pragma unroll 8
    for (int c = e & 7; c < C; c += 8)
      xo[i * C + c] = p != nullptr ? p[c] : 0.f;
  }
  for (int e = threadIdx.x; e < heads * kQT * DP; e += blockDim.x) qs[e] = 0.f;
  __syncthreads();

  project_tile(xo, w_q, C, work, [&](int m, int c, float acc) {
    qs[((c / d) * kQT + m) * DP + c % d] = acc + b_q[c];
  });

  const int nw_img = (H / ws) * (W / ws);
  const float* mw =
      mask == nullptr
          ? nullptr
          : mask + (static_cast<long long>(n_mask == 1 ? 0 : widx % nw_img) *
                        n + q0) * nk;
  const float* kvw = kv + static_cast<long long>(widx) * nk * 2 * C;
  for (int h = 0; h < heads; ++h) {
    // the previous head's tile, and the projection, ended with a barrier
    srk::load_rows_any<float, DP>(ks, nk, nk4, d, [&](int j) {
      return kvw + static_cast<long long>(j) * 2 * C + h * d;
    });
    srk::load_rows_any<float, DP>(vs, nk, nk4, d, [&](int j) {
      return kvw + static_cast<long long>(j) * 2 * C + C + h * d;
    });
    __syncthreads();
    const float* bh = bias + (static_cast<long long>(h) * n + q0) * nk;
    srk::attend_tile<float, DP, kQT>(
        qs + h * kQT * DP, qt, ks, vs, nk, sc, red, d, scale,
        [&](int i, int j) {
          const int at = i * nk + j;
          return mw == nullptr ? bh[at] : bh[at] + mw[at];
        },
        [&](int i, int t, float o) { xo[i * C + h * d + t] = o; });
  }

  project_tile(xo, w_proj, C, work, [&](int m, int c, float acc) {
    if (m < qt) out[win.pixel(q0 + m) * C + c] = acc + b_proj[c];
  });
}

template <int DP>
cudaError_t launch(const float* x, const float* w_q, const float* b_q,
                   const float* w_proj, const float* b_proj, const float* kv,
                   const float* bias, const float* mask, int n_mask,
                   float* out, int B, int H, int W, int C, int heads, int ws,
                   float scale, cudaStream_t stream) {
  const int n = ws * ws;
  const int windows = B * (H / ws) * (W / ws);
  const size_t smem = smem_bytes(n / 4, DP, C, heads);
  cudaError_t err = srk::set_smem(psa_block_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(windows) * ((n + kQT - 1) / kQT);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  psa_block_kernel<DP>
      <<<static_cast<unsigned>(blocks), srk::kTileThreads, smem, stream>>>(
          x, w_q, b_q, w_proj, b_proj, kv, bias, mask, n_mask, out, windows,
          H, W, C, heads, ws, scale);
  return cudaGetLastError();
}

// The tensor-core kernel's names live in their own namespace: kSlab and
// smem_bytes above are the FMA kernel's.
namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;
constexpr int kRows = 64;    // query rows of a block, 16 a warp
constexpr int kThreads = kRows / 16 * 32;
constexpr int kChunk = 48;   // keys of a chunk (SRFormer's 144 = 3 x 48)
constexpr int kSlab = 64;    // weight rows of a projection step
constexpr int kPanel = 64;   // output columns of a projection step
constexpr int kPad = 8;      // elements after each shared-memory row
// k and v tiles are read by the tile's score and P V steps
// (mma_attention.cuh), which pad their rows by kKvPad
static_assert(kPad == mma::kKvPad, "k and v rows as the tile pads them");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Row stride (bf16) of the q tile: C rounded up to 16, plus kPad.
__host__ __device__ constexpr int q_stride(int c) {
  return (c + 15) / 16 * 16 + kPad;
}

// An attention stage: the bias and mask tiles (kRows x kChunk float32), k
// and v (kChunk x dp bf16). A projection stage: a slab of x (kRows x kSlab)
// and of a weight (kSlab x kPanel), bf16. Rows padded by kPad.
__host__ __device__ constexpr int att_stage_bytes(int dp) {
  return 2 * 4 * kRows * (kChunk + kPad) + 2 * 2 * kChunk * (dp + kPad);
}

__host__ __device__ constexpr int proj_stage_bytes() {
  return 2 * kRows * (kSlab + kPad) + 2 * kSlab * (kPanel + kPad);
}

__host__ __device__ constexpr int stage_bytes(int dp) {
  return cmax(att_stage_bytes(dp), proj_stage_bytes());
}

// The q tile, the rows' pixel offsets (an int each) and two stages.
__host__ __device__ constexpr int mma_smem_bytes(int c, int dp) {
  return 2 * kRows * q_stride(c) + 4 * kRows + 2 * stage_bytes(dp);
}

struct PsaArgs {
  const bf16* x;
  const bf16* w_q;
  const bf16* b_q;
  const bf16* w_proj;
  const bf16* b_proj;
  const bf16* kv;
  const float* bias;
  const float* mask;
  bf16* out;
  int n_mask, H, W, C, heads, ws;
  float scale;
  bool vec;       // C % 4 == 0, d even, x and weights 8-byte, kv 4-byte aligned
  bool vec_bias;  // nk % 4 == 0, bias and mask 16-byte aligned
};

// acc of one projection step: the warp's 16 rows of A (stride ast, from
// column a0) times a staged weight slab, over ksteps steps of 16.
__device__ __forceinline__ void project_slab(const bf16* a, int ast, int a0,
                                             const bf16* wsl, int ksteps,
                                             float (&acc)[kPanel / 8][4]) {
  constexpr int WST = kPanel + kPad;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kSlab / 16; ++kk) {
    if (kk >= ksteps) break;
    uint32_t af[4];
    mma::ldsm_x4(af, a + (8 * (mi & 1) + r8) * ast + a0 + kk * 16 +
                         8 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < kPanel / 16; ++np) {
      uint32_t b[4];
      mma::ldsm_x4_trans(b, wsl + (kk * 16 + 8 * (mi & 1) + r8) * WST +
                                np * 16 + 8 * (mi >> 1));
      mma::mma_bf16(acc[2 * np], af, b[0], b[1]);
      mma::mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// A projection of the block's 64 rows by the (C, C) weight w: panels of
// kPanel output columns, each summed over slabs of kSlab input rows, the
// copies of step t + 1 in flight while step t is computed. FROM_X: the rows
// are x's, staged with each slab (pix: a row's pixel offset from first, -1
// past the window); else the q tile's. epi(r, c, v0, v1) gets columns c
// and c + 1 (c even, c < C) of block row r. Ends with a block barrier.
template <bool FROM_X, typename Epi>
__device__ __forceinline__ void project(const PsaArgs& a, const bf16* w,
                                        const bf16* qt, const int* pix,
                                        long long first, unsigned char* stages,
                                        int sb, Epi epi) {
  constexpr int XST = kSlab + kPad, WST = kPanel + kPad;
  const int C = a.C, kp = (C + 15) / 16 * 16, qs = q_stride(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int slabs = (kp + kSlab - 1) / kSlab;
  const int steps = slabs * ((C + kPanel - 1) / kPanel);
  auto x_slab = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * sb);
  };
  auto w_slab = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * sb + 2 * kRows * XST);
  };
  auto load = [&](int p, int s, int st) {
    const int k0 = s * kSlab, n0 = p * kPanel;
    bf16* wd = w_slab(st);
    bf16* xd = x_slab(st);
    if (a.vec) {  // C % 4 == 0: a piece of 4 lies inside C or past it
      for (int e = tid; e < kSlab * kPanel / 4; e += kThreads) {
        const int r = e / (kPanel / 4), c = (e % (kPanel / 4)) * 4;
        const bool ok = k0 + r < C && n0 + c < C;
        mma::cp_async8(wd + r * WST + c,
                       ok ? w + static_cast<long long>(k0 + r) * C + n0 + c
                          : w,
                       ok);
      }
      if (FROM_X)
        for (int e = tid; e < kRows * kSlab / 4; e += kThreads) {
          const int r = e / (kSlab / 4), c = (e % (kSlab / 4)) * 4;
          const bool ok = pix[r] >= 0 && k0 + c < C;
          mma::cp_async8(xd + r * XST + c,
                         ok ? a.x + (first + pix[r]) * C + k0 + c : a.x, ok);
        }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < kSlab * kPanel; e += kThreads) {
        const int r = e / kPanel, c = e % kPanel;
        wd[r * WST + c] = (k0 + r < C && n0 + c < C)
                              ? w[static_cast<long long>(k0 + r) * C + n0 + c]
                              : zero;
      }
      if (FROM_X)
        for (int e = tid; e < kRows * kSlab; e += kThreads) {
          const int r = e / kSlab, c = e % kSlab;
          xd[r * XST + c] = (pix[r] >= 0 && k0 + c < C)
                                ? a.x[(first + pix[r]) * C + k0 + c]
                                : zero;
        }
    }
    mma::cp_async_commit();
  };

  float acc[kPanel / 8][4];
  int p = 0, s = 0;
  load(0, 0, 0);
  for (int t = 0; t < steps; ++t) {
    int np = p, ns = s + 1;
    if (ns == slabs) {
      ns = 0;
      ++np;
    }
    // the stage of step t + 1 was last read in step t - 1, which ended
    // with a block barrier
    if (t + 1 < steps) {
      load(np, ns, (t + 1) & 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    const int ksteps = min(kSlab, kp - s * kSlab) / 16;
    if (FROM_X)
      project_slab(x_slab(t & 1) + warp * 16 * XST, XST, 0, w_slab(t & 1),
                   ksteps, acc);
    else
      project_slab(qt + warp * 16 * qs, qs, s * kSlab, w_slab(t & 1), ksteps,
                   acc);
    __syncthreads();
    if (s == slabs - 1) {
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j) {
        const int c = p * kPanel + j * 8 + 2 * tig;
        if (c >= C) continue;
        const int r = warp * 16 + gid;
        epi(r, c, acc[j][0], acc[j][1]);
        epi(r + 8, c, acc[j][2], acc[j][3]);
      }
    }
    p = np;
    s = ns;
  }
}

// The block: grid (windows, ceil(N / kRows)), windows fastest.
template <int DP, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    mma_psa_block_kernel(PsaArgs a) {
  constexpr int KST = DP + kPad, BST = kChunk + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, ws = a.ws, n = ws * ws, nk = n / 4, d = C / a.heads;
  const int qs = q_stride(C), sb = stage_bytes(DP);
  const int widx = blockIdx.x, q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);  // kRows x qs
  int* pix = reinterpret_cast<int*>(smem_raw + 2 * kRows * qs);
  unsigned char* stages = smem_raw + 2 * kRows * qs + 4 * kRows;
  const srk::Window win = srk::window_of(widx, a.H, a.W, ws);

  for (int r = tid; r < kRows; r += kThreads)
    pix[r] = q0 + r < n ? static_cast<int>(win.pixel(q0 + r) - win.first)
                        : -1;
  for (int e = tid; e < kRows * qs / 8; e += kThreads)
    reinterpret_cast<uint4*>(qt)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // q = round(x W_q + b_q) into the q tile
  project<true>(a, a.w_q, qt, pix, win.first, stages, sb,
                [&](int r, int c, float v0, float v1) {
                  qt[r * qs + c] =
                      __float2bfloat16(v0 + __bfloat162float(a.b_q[c]));
                  if (c + 1 < C)
                    qt[r * qs + c + 1] =
                        __float2bfloat16(v1 + __bfloat162float(a.b_q[c + 1]));
                });

  // attention, steps (head, pass, chunk) in that order
  const int nc = (nk + kChunk - 1) / kChunk, steps = a.heads * 2 * nc;
  const bf16* kvw = a.kv + static_cast<long long>(widx) * nk * 2 * C;
  const int nw_img = (a.H / ws) * (a.W / ws);
  const float* mw =
      MASKED ? a.mask + static_cast<long long>(a.n_mask == 1 ? 0
                                                             : widx % nw_img) *
                            n * nk
             : nullptr;
  auto bias_tile = [&](int st) {
    return reinterpret_cast<float*>(stages + st * sb);
  };
  auto mask_tile = [&](int st) { return bias_tile(st) + kRows * BST; };
  auto kv_tile = [&](int st, int part) {
    return reinterpret_cast<bf16*>(stages + st * sb + 2 * 4 * kRows * BST) +
           part * kChunk * KST;
  };
  // rows q0 .. q0 + 63 and keys c0 .. c0 + kChunk - 1 of an (n, nk) float32
  // matrix, zero past them
  auto load_tile = [&](float* dst, const float* src, int c0) {
    if (a.vec_bias) {
      for (int e = tid; e < kRows * kChunk / 4; e += kThreads) {
        const int r = e / (kChunk / 4), c = (e % (kChunk / 4)) * 4;
        const bool ok = q0 + r < n && c0 + c < nk;
        mma::cp_async16(
            dst + r * BST + c,
            ok ? src + static_cast<long long>(q0 + r) * nk + c0 + c : src,
            ok);
      }
    } else {
      for (int e = tid; e < kRows * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        dst[r * BST + c] =
            (q0 + r < n && c0 + c < nk)
                ? src[static_cast<long long>(q0 + r) * nk + c0 + c]
                : 0.f;
      }
    }
  };
  // the copies of step (h, pass, c): bias, mask, k, and v in pass 2
  auto load = [&](int h, int pass, int c, int st) {
    const int c0 = c * kChunk;
    load_tile(bias_tile(st), a.bias + static_cast<long long>(h) * n * nk, c0);
    if (MASKED) load_tile(mask_tile(st), mw, c0);
    bf16* kd = kv_tile(st, 0);
    bf16* vd = kv_tile(st, 1);
    if (a.vec) {
      for (int e = tid; e < kChunk * (DP / 2); e += kThreads) {
        const int j = e / (DP / 2), t = 2 * (e % (DP / 2));
        const bool key = c0 + j < nk;
        const bool ok = key && t < d;
        const bf16* src = kvw +
                          static_cast<long long>(key ? c0 + j : 0) * 2 * C +
                          h * d + t;
        mma::cp_async4(kd + j * KST + t, src, ok);
        if (pass) mma::cp_async4(vd + j * KST + t, src + C, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < kChunk * DP; e += kThreads) {
        const int j = e / DP, t = e % DP;
        const bool ok = c0 + j < nk && t < d;
        const bf16* src =
            kvw + static_cast<long long>(c0 + j) * 2 * C + h * d + t;
        kd[j * KST + t] = ok ? src[0] : zero;
        if (pass) vd[j * KST + t] = ok ? src[C] : zero;
      }
    }
    mma::cp_async_commit();
  };

  const int r0 = warp * 16 + gid;
  uint32_t qf[DP / 16][4];
  float o[DP / 8][4];
  float m[2], l[2];
  int h = 0, pass = 0, c = 0;
  load(0, 0, 0, 0);
  for (int t = 0; t < steps; ++t) {
    int nh = h, npass = pass, ncc = c + 1;
    if (ncc == nc) {
      ncc = 0;
      if (++npass == 2) {
        npass = 0;
        ++nh;
      }
    }
    // the stage of step t + 1 was last read in step t - 1, which ended
    // with a block barrier
    if (t + 1 < steps) {
      load(nh, npass, ncc, (t + 1) & 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (c == 0 && pass == 0) {
      // q of head h as A fragments: its own rows of the q tile, whose
      // columns of this head no other head's output has reached
      const bf16* qa = qt + r0 * qs + h * d;
      const bf16* qb = qa + 8 * qs;
      auto at = [&](const bf16* row, int i) {
        return i < d ? row[i] : __float2bfloat16(0.f);
      };
#pragma unroll
      for (int kt = 0; kt < DP / 16; ++kt) {
        const int i = kt * 16 + 2 * tig;
        qf[kt][0] = mma::pack(at(qa, i), at(qa, i + 1));
        qf[kt][1] = mma::pack(at(qb, i), at(qb, i + 1));
        qf[kt][2] = mma::pack(at(qa, i + 8), at(qa, i + 9));
        qf[kt][3] = mma::pack(at(qb, i + 8), at(qb, i + 9));
      }
      mma::clear_rows<DP>(o, m, l);
    }
    if (c == 0 && pass == 1) {
      // each row's exponent base and 1 / denominator, in place of m and l
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = mma::exp_base(m[i]);
        l[i] = 1.f / mma::quad_sum(l[i]);
      }
    }
    const int st = t & 1;
    const int kc = min(kChunk, nk - c * kChunk);
    if (MASKED) {
      // bias += mask over the warp's own 16 rows, which no other warp reads
      float4* bw = reinterpret_cast<float4*>(bias_tile(st) + warp * 16 * BST);
      const float4* mw4 =
          reinterpret_cast<const float4*>(mask_tile(st) + warp * 16 * BST);
      static_assert(16 * kChunk / 4 % 32 == 0, "whole float4s a lane");
#pragma unroll
      for (int i = 0; i < 16 * kChunk / 4 / 32; ++i) {
        const int e = i * 32 + lane;
        const int at = (e / (kChunk / 4)) * (BST / 4) + e % (kChunk / 4);
        const float4 bv = bw[at], mv = mw4[at];
        bw[at] = make_float4(bv.x + mv.x, bv.y + mv.y, bv.z + mv.z,
                             bv.w + mv.w);
      }
      __syncwarp();
    }
    const float* b0 = bias_tile(st) + r0 * BST;
    const bf16* ks = kv_tile(st, 0);
    const float* b1 = b0 + 8 * BST;
    if (pass == 0) {
      if (kc == kChunk)
        mma::stats_step<DP, false, kChunk>(qf, ks, b0, b1, kc, a.scale, m, l);
      else
        mma::stats_step<DP, true, kChunk>(qf, ks, b0, b1, kc, a.scale, m, l);
    } else {
      const bf16* vs = kv_tile(st, 1);
      if (kc == kChunk)
        mma::normalised_step<DP, false, kChunk>(qf, ks, vs, b0, b1, kc,
                                                a.scale, m, l, o);
      else
        mma::normalised_step<DP, true, kChunk>(qf, ks, vs, b0, b1, kc,
                                               a.scale, m, l, o);
      if (c == nc - 1) {
        // the head's output, rounded, over its q columns: the head concat
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = j * 8 + 2 * tig + e;
            if (i >= d) continue;
            qt[r0 * qs + h * d + i] = __float2bfloat16(o[j][e]);
            qt[(r0 + 8) * qs + h * d + i] = __float2bfloat16(o[j][2 + e]);
          }
        }
      }
    }
    __syncthreads();
    h = nh;
    pass = npass;
    c = ncc;
  }

  // out = round(concat W_proj + b_proj), in image layout
  project<false>(a, a.w_proj, qt, pix, win.first, stages, sb,
                 [&](int r, int c, float v0, float v1) {
                   if (pix[r] < 0) return;
                   bf16* dst = a.out + (win.first + pix[r]) * C + c;
                   dst[0] =
                       __float2bfloat16(v0 + __bfloat162float(a.b_proj[c]));
                   if (c + 1 < C)
                     dst[1] = __float2bfloat16(
                         v1 + __bfloat162float(a.b_proj[c + 1]));
                 });
}

template <int DP, bool MASKED>
cudaError_t launch_mma(const PsaArgs& a, int windows, cudaStream_t stream) {
  const int smem = mma_smem_bytes(a.C, DP);
  cudaError_t err = srk::set_smem(mma_psa_block_kernel<DP, MASKED>, smem);
  if (err != cudaSuccess) return err;
  const int n = a.ws * a.ws;
  const dim3 grid(windows, (n + kRows - 1) / kRows);
  mma_psa_block_kernel<DP, MASKED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

bool bad_shape(int B, int H, int W, int C, int heads, int ws) {
  return heads < 1 || C % heads || ws < 2 || ws % 2 || H % ws || W % ws ||
         B < 1 || C / heads > 32;
}

}  // namespace

// Bytes of dynamic shared memory a block of the FMA kernel needs for window
// ws, C channels in `heads` heads; the wrapper holds this against the
// card's limit.
extern "C" int sr_psa_block_smem(int ws, int C, int heads) {
  return static_cast<int>(
      smem_bytes(ws * ws / 4, pad_of(C / heads), C, heads));
}

// The same for the tensor-core kernel, whatever the window.
extern "C" int sr_mma_psa_block_smem(int C, int heads) {
  return tc::mma_smem_bytes(C, C / heads <= 16 ? 16 : 32);
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_psa_block's. x, out (B, H, W, C); w_q, w_proj (C, C) as (in, out);
// b_q, b_proj (C); kv (B * nW, ws^2 / 4, 2C); bias (heads, ws^2, ws^2 / 4)
// float32; mask (n_mask, ws^2, ws^2 / 4) float32 with n_mask 1 or the
// windows of one image, or null for no mask. Head dims up to 32, ws even.
// Returns the cudaError_t of the launch.
extern "C" int sr_psa_block(int dtype, const void* x, const void* w_q,
                            const void* b_q, const void* w_proj,
                            const void* b_proj, const void* kv,
                            const void* bias, const void* mask, int n_mask,
                            void* out, int B, int H, int W, int C, int heads,
                            int ws, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || bad_shape(B, H, W, C, heads, ws))
    return cudaErrorInvalidValue;
  if (mask != nullptr && n_mask != 1 && n_mask != (H / ws) * (W / ws))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  return C / heads <= 16
             ? launch<16>(f(x), f(w_q), f(b_q), f(w_proj), f(b_proj), f(kv),
                          f(bias), f(mask), n_mask, o, B, H, W, C, heads, ws,
                          scale, st)
             : launch<32>(f(x), f(w_q), f(b_q), f(w_proj), f(b_proj), f(kv),
                          f(bias), f(mask), n_mask, o, B, H, W, C, heads, ws,
                          scale, st);
}

// fused_psa_block in bf16 on the tensor cores: operands as sr_psa_block's,
// x, weights, kv and out bf16; the shared memory is sr_mma_psa_block_smem's.
// Returns the cudaError_t of the launch.
extern "C" int sr_mma_psa_block(const void* x, const void* w_q,
                                const void* b_q, const void* w_proj,
                                const void* b_proj, const void* kv,
                                const void* bias, const void* mask,
                                int n_mask, void* out, int B, int H, int W,
                                int C, int heads, int ws, float scale,
                                void* stream) {
  if (bad_shape(B, H, W, C, heads, ws) ||
      (ws * ws + tc::kRows - 1) / tc::kRows > 65535)
    return cudaErrorInvalidValue;
  if (mask != nullptr && n_mask != 1 && n_mask != (H / ws) * (W / ws))
    return cudaErrorInvalidValue;
  const int d = C / heads, nk = ws * ws / 4;
  auto aligned = [](const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  tc::PsaArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w_q = static_cast<const __nv_bfloat16*>(w_q);
  a.b_q = static_cast<const __nv_bfloat16*>(b_q);
  a.w_proj = static_cast<const __nv_bfloat16*>(w_proj);
  a.b_proj = static_cast<const __nv_bfloat16*>(b_proj);
  a.kv = static_cast<const __nv_bfloat16*>(kv);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n_mask = n_mask;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.ws = ws;
  a.scale = scale;
  // x and weight rows start at multiples of C values, kv rows at
  // multiples of 2C plus h * d: 8- and 4-byte aligned for C % 4 == 0, d even
  a.vec = C % 4 == 0 && d % 2 == 0 && aligned(x, 8) && aligned(w_q, 8) &&
          aligned(w_proj, 8) && aligned(kv, 4);
  a.vec_bias = nk % 4 == 0 && aligned(bias, 16) &&
               (mask == nullptr || aligned(mask, 16));
  const int windows = B * (H / ws) * (W / ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16)
    return mask ? tc::launch_mma<16, true>(a, windows, st)
                : tc::launch_mma<16, false>(a, windows, st);
  return mask ? tc::launch_mma<32, true>(a, windows, st)
              : tc::launch_mma<32, false>(a, windows, st);
}
