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
// under the 295 FLOP/byte ridge of the bf16 tensor cores, so on them it is
// bound by its bytes: 147 MB at the flagship chunk of four 160 x 160
// tiles, 0.044 ms (mlp_block: 74 MB, 0.022 ms, under its 26.5 GFLOP's
// 0.027 ms).
//
// Cast points, those of the TPU kernel (_mlp_tail_math, :282-312): the
// 3-way sum stays float32; the LayerNorm statistics are taken over it;
// LN(x) is rounded to T before fc1; fc1 is summed in float32 with b1, then
// GELU, rounded to T before fc2; out = fc2 + b2 + rs * x with x still
// float32, rounded once at the store. The plain versions round the sum
// first, as the JAX reference does (:640-641).
//
// In bf16 it is mma_mlp_tail_kernel (namespace tc), both products on the
// tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums). A block
// of kWarps warps takes kBlockRows pixels, 16 a warp, and a warp owns its
// rows through both products, so the hidden activation never leaves the
// warp's registers:
//   prologue  each lane reads its rows' channels in the accumulator layout
//             of fc2 (rows gid and gid + 8, channels 8j + 2 tig, + 1),
//             forms the float32 x, takes the LayerNorm statistics over it
//             across the row's quad of lanes (two passes), writes LN(x)
//             rounded to bf16 into its rows of the A tile with a column of
//             ones after it (W1's stage holds b1 in that row, so fc1 adds
//             b1), and starts the fc2 accumulators at rs * x + b2: x is
//             not needed again;
//   steps     over panels of kHidPanel hidden columns, whose W1 columns and
//             W2 rows come through kStages shared-memory stages by cp.async
//             ahead of use: GELU of step t's fc1 sums (the TPU kernel's
//             A&S erf), rounded to bf16 straight into fc2's A fragments
//             (the m16n8 sums of two n8 tiles are the m16k16 fragment);
//             fc1 of step t + 1 (A tile by its W1 columns), with no branch
//             between, so the two overlap; fc2 of step t into C-wide
//             float32 accumulators (NT n8 tiles, a template argument);
//   epilogue  the accumulators rounded once, staged through shared memory
//             and written as whole runs of each row (mma_proj.cuh's
//             write_rows).
// Every loop of a step has a fixed trip count: the kernel computes
// width(C) = C + 1 rounded up to 64 columns (8 NT), zero past the ones
// column, so C 180 and C 60 cost nothing extra, C 240 7%.
// Shared memory (tc::smem_bytes, twin cuda_ffn.mma_mlp_tail_smem): the A
// tile and kStages stages, whatever the hidden width: 2 * 128 * 200 +
// 3 * (2 * 192 * 40 + 2 * 32 * 200) = 135,680 bytes at C 180; 179,712 at
// C 240. The hidden width sets only the number of steps. The registers
// (the accumulators are 4 NT a lane) allow one block an SM.
//
// mma_hab_tail_kernel is the same kernel with fused_hab_block's output
// projection in front (the third launch of sr_mma_hab_block, hab_block.cu;
// the TPU kernel's _hab_block_kernel, pallas_attention.py:1651-1658): the
// A tile first holds the block's rows of the bf16 head concat, the
// accumulators start at s + cs * cv + bproj, and Wproj's rows come through
// the stages' W2 rows, kHidPanel a step, as fc2's do; the concat times
// Wproj then adds up in the C-wide float32 accumulators, which then hold
// the 3-way sum x, float32 as in the TPU kernel; the projection's pipeline
// is drained, and the prologue's statistics, LN2 into the A tile and the
// MLP's steps follow as in mma_mlp_tail_kernel: one body (tail_rows), the
// MLP's steps the same code. Same shared memory.
//
// In float32 it is mlp_tail_kernel below, the first version and the exact
// check on the card; its entry refuses bf16. One block takes kRows pixels.
// The float32 block input, its LayerNorm and gelu(fc1) (exact erff) stay
// in shared memory (block_parts.cuh::mlp_tail_rows, which hab_block.cu
// shares), and both products run as float32 FMA loops on the CUDA cores.
#include <stdint.h>

#include "block_parts.cuh"
#include "mma_proj.cuh"

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

bool bad_shape(int B, int H, int W, int C, int hid, int sum3, int ss) {
  return B < 1 || H < 1 || W < 1 || C < 1 || hid < 1 || ss < 0 ||
         (ss && !sum3);
}

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = mma::kProjWarps;  // warps of a block, 16 rows each
constexpr int kBlockRows = 16 * kWarps;
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kHidPanel = 32;  // hidden columns of a step
constexpr int kStages = 3;     // weight stages: two steps' copies in flight
constexpr int kW1Stride = kHidPanel + mma::kProjPad;  // bf16 a W1 stage row
constexpr int kMaxWidth = 256;  // the widest row the accumulators hold
// Wproj rows a step of mma_hab_tail_kernel's projection, at the start of a
// stage (up to 64 fit at any width); 64 took 4% longer than 32
// (tools/mlp_tail_variants.py, the flagship chunk, an H100)
constexpr int kProjStep = 32;
static_assert(kProjStep % kHidPanel == 0, "whole W2-sized pieces");

// Columns of the A tile for C: C and the ones column that adds b1 in fc1,
// rounded up to 64 and zero past them, so that every loop of a step has a
// fixed trip count (8 * NT = width(C)).
__host__ __device__ constexpr int width(int c) { return (c + 64) / 64 * 64; }

// Row stride (bf16) of the A tile and of a W2 stage: the width plus the
// pad that puts the 8 rows of an ldmatrix in distinct banks.
__host__ __device__ constexpr int stride(int c) {
  return width(c) + mma::kProjPad;
}

// Bytes of a stage: the step's W1 columns (width rows of kHidPanel,
// padded) and its W2 rows (kHidPanel rows of the stride).
__host__ __device__ constexpr int stage_bytes(int c) {
  return 2 * width(c) * kW1Stride + 2 * kHidPanel * stride(c);
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The A tile and kStages stages, which the epilogue's staged output tiles
// (a warp's 16 rows of kRowsStride) reuse.
__host__ __device__ constexpr int smem_bytes(int c) {
  return 2 * kBlockRows * stride(c) +
         cmax(kStages * stage_bytes(c), kWarps * 16 * mma::kRowsStride * 2);
}

struct TailArgs {
  const bf16* s;   // (m, C)
  const bf16* a;   // (m, C), read at the rolled pixel where ss > 0
  const bf16* cv;  // (m, C)
  const bf16* gamma;
  const bf16* beta;
  const bf16* w1;  // (C, hid)
  const bf16* b1;
  const bf16* w2;  // (hid, C)
  const bf16* b2;
  mma::RowsOut out;  // (m, C)
  long long m;
  int H, W, C, hid, sum3, ss;
  float cs, eps, rs;
  bool pairs;           // C even and s, a, cv 4-byte aligned: channels
                        // read as bf16 pairs
  bool vec_w1, vec_w2;  // 16-byte copies of w1's rows; 8-byte of w2's
};

// Values q[0], q[1] of a bf16 row as floats, each zero where its flag is
// false (its load then predicated off). PAIRS: one aligned 4-byte word.
template <bool PAIRS>
__device__ __forceinline__ float2 pair_at(const bf16* q, bool ok0, bool ok1) {
  float2 v = make_float2(0.f, 0.f);
  if (PAIRS) {
    if (ok0)
      v = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(q)));
  } else {
    if (ok0) v.x = __bfloat162float(__ldg(q));
    if (ok1) v.y = __bfloat162float(__ldg(q + 1));
  }
  return v;
}

// x of the lane's rows gid, gid + 8 in the accumulator layout of fc2:
// acc[j] holds channels 8j + 2 tig, + 1 of both rows, float32, zero past C
// and for a dead row (!live[h]). row_s[h], row_c[h]: the rows of s and cv;
// row_a[h]: the attention input's row at the rolled pixel.
template <int NT, bool SUM3, bool PAIRS>
__device__ __forceinline__ void read_x(float (&acc)[NT][4],
                                       const bf16* const (&row_s)[2],
                                       const bf16* const (&row_a)[2],
                                       const bf16* const (&row_c)[2],
                                       const bool (&live)[2], int C, int tig,
                                       float cs) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok0 = live[h] && c < C, ok1 = live[h] && c + 1 < C;
      float2 v = pair_at<PAIRS>(row_s[h] + c, ok0, ok1);
      if (SUM3) {
        const float2 va = pair_at<PAIRS>(row_a[h] + c, ok0, ok1);
        const float2 vc = pair_at<PAIRS>(row_c[h] + c, ok0, ok1);
        v.x = v.x + va.x + vc.x * cs;
        v.y = v.y + va.y + vc.y * cs;
      }
      acc[j][2 * h] = v.x;
      acc[j][2 * h + 1] = v.y;
    }
  }
}

// GELU with the TPU kernel's erf (common.cuh).
using srk::gelu_as;

// s + cs * cv + bproj of the lane's rows in the accumulator layout of
// read_x, float32, zero past C and for a dead row: where fused_hab_block's
// output projection o Wproj then adds up, the 3-way sum x = s + (o Wproj
// + bproj) + cs * cv in float32, added in another order than the TPU
// kernel's.
template <int NT, bool PAIRS>
__device__ __forceinline__ void start_sum3(float (&acc)[NT][4],
                                           const bf16* const (&row_s)[2],
                                           const bf16* const (&row_c)[2],
                                           const bf16* bproj,
                                           const bool (&live)[2], int C,
                                           int tig, float cs) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * tig;
    const float2 bp = pair_at<false>(bproj + c, c < C, c + 1 < C);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok0 = live[h] && c < C, ok1 = live[h] && c + 1 < C;
      const float2 vs = pair_at<PAIRS>(row_s[h] + c, ok0, ok1);
      const float2 vc = pair_at<PAIRS>(row_c[h] + c, ok0, ok1);
      acc[j][2 * h] = ok0 ? vs.x + vc.x * cs + bp.x : 0.f;
      acc[j][2 * h + 1] = ok1 ? vs.y + vc.y * cs + bp.y : 0.f;
    }
  }
}

// out = round(rs * x + fc2(gelu(fc1(LN(x))))) for kBlockRows pixels, C up
// to 8 NT: width(C) == 8 NT. The body of both tensor-core kernels: HAB
// (mma_hab_tail_kernel) starts the accumulators at start_sum3's and adds
// the block's rows of the head concat a.a times wproj, kHidPanel rows a
// step through the same stages (their pipeline drained before the MLP's
// starts), which makes x (vec_o: the concat's rows in 8-byte copies);
// without HAB (mma_mlp_tail_kernel) wproj, bproj and vec_o are not read
// and x is read_x's. The MLP's steps are the same code in both.
template <int NT, bool HAB>
__device__ __forceinline__ void tail_rows(const TailArgs& a,
                                          const bf16* wproj,
                                          const bf16* bproj, bool vec_o) {
  constexpr int kW = 8 * NT, kAst = kW + mma::kProjPad;
  constexpr int kW1Bytes = 2 * kW * kW1Stride;
  constexpr int kStageBytes = kW1Bytes + 2 * kHidPanel * kAst;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, hid = a.hid;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockRows;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stages = smem_raw + 2 * kBlockRows * kAst;
  const int steps = (hid + kHidPanel - 1) / kHidPanel;

  // kHidPanel rows of the (n x C) matrix src from row r0 into the W2 rows
  // of a stage (d2), zero past n and past C
  auto load_rows = [&](bf16* d2, const bf16* src0, int r0, int n) {
    const bf16 zero = __float2bfloat16(0.f);
    // a warp a row at a time, 8-byte pieces
#pragma unroll
    for (int i = 0; i < kHidPanel / kWarps; ++i) {
      const int r = warp + i * kWarps;
      const bf16* src = src0 + static_cast<long long>(r0 + r) * C;
      const bool row_ok = r0 + r < n;
      if (a.vec_w2) {
#pragma unroll
        for (int k = 0; k < (kW / 4 + 31) / 32; ++k) {
          const int c = 4 * lane + 128 * k;
          const bool ok = row_ok && c < C;
          if (c < kW)
            mma::cp_async8(d2 + r * kAst + c, ok ? src + c : src0, ok);
        }
      } else {
        for (int c = lane; c < kW; c += 32)
          d2[r * kAst + c] = row_ok && c < C ? src[c] : zero;
      }
    }
  };
  // step p's W1 columns (b1 in row C) and W2 rows into stage st, zero
  // past them and past hid; one commit group a call, empty past the last
  // step
  auto load = [&](int p, int st) {
    if (p < steps) {
      const int h0 = p * kHidPanel;
      bf16* d1 = reinterpret_cast<bf16*>(stages + st * kStageBytes);
      bf16* d2 =
          reinterpret_cast<bf16*>(stages + st * kStageBytes + kW1Bytes);
      const bf16 zero = __float2bfloat16(0.f);
      if (a.vec_w1) {
        // 16-byte pieces, kHidPanel / 8 a row
        constexpr int kPieces = kHidPanel / 8;
#pragma unroll
        for (int i = 0; i < (kW * kPieces + kBlockThreads - 1) / kBlockThreads;
             ++i) {
          const int e = tid + i * kBlockThreads;
          if (kW * kPieces % kBlockThreads && e >= kW * kPieces) break;
          const int r = e / kPieces, c = (e % kPieces) * 8;
          const bool ok = r <= C && h0 + c < hid;
          const bf16* src = r < C ? a.w1 + static_cast<long long>(r) * hid
                                  : a.b1;
          mma::cp_async16(d1 + r * kW1Stride + c, ok ? src + h0 + c : a.w1,
                          ok);
        }
      } else {
        for (int e = tid; e < kW * kHidPanel; e += kBlockThreads) {
          const int r = e / kHidPanel, c = e % kHidPanel;
          const bool ok = r <= C && h0 + c < hid;
          d1[r * kW1Stride + c] =
              !ok ? zero
                  : r < C ? a.w1[static_cast<long long>(r) * hid + h0 + c]
                          : a.b1[h0 + c];
        }
      }
      load_rows(d2, a.w2, h0, hid);
    }
    mma::cp_async_commit();
  };
  float acc[NT][4];  // x in float32, then rs * x + b2 + fc2
  if constexpr (HAB) {
    // the block's rows of the head concat into the A tile, zero past C
    // and past the last pixel; the first commit group takes them
    const bf16 zero = __float2bfloat16(0.f);
    if (vec_o) {
      for (int e = tid; e < kBlockRows * (kW / 4); e += kBlockThreads) {
        const int r = e / (kW / 4), c = (e % (kW / 4)) * 4;
        const bool ok = row0 + r < a.m && c < C;
        mma::cp_async8(at + r * kAst + c,
                       ok ? a.a + (row0 + r) * C + c : a.a, ok);
      }
    } else {
      for (int e = tid; e < kBlockRows * kW; e += kBlockThreads) {
        const int r = e / kW, c = e % kW;
        at[r * kAst + c] =
            row0 + r < a.m && c < C ? a.a[(row0 + r) * C + c] : zero;
      }
    }
    // the projection: the warp's 16 concat rows by Wproj's, kProjStep
    // rows a step (at the start of a stage, kHidPanel rows a piece), into
    // the C-wide accumulators
    static_assert(2 * kProjStep * kAst <= kStageBytes,
                  "a projection step fits a stage");
    const int proj_steps = (C + kProjStep - 1) / kProjStep;
    auto load_proj = [&](int t, int st) {
      if (t < proj_steps) {
        bf16* d = reinterpret_cast<bf16*>(stages + st * kStageBytes);
#pragma unroll
        for (int u = 0; u < kProjStep / kHidPanel; ++u)
          load_rows(d + u * kHidPanel * kAst, wproj,
                    t * kProjStep + u * kHidPanel, C);
      }
      mma::cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) load_proj(t, t);
    // the shortcut's and conv's rows are read while the copies land
    {
      const bf16* row_s[2];
      const bf16* row_c[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = row0 + warp * 16 + gid + 8 * h;
        live[h] = p < a.m;
        row_s[h] = a.s + (live[h] ? p : 0) * C;
        row_c[h] = a.cv + (live[h] ? p : 0) * C;
      }
      if (a.pairs)
        start_sum3<NT, true>(acc, row_s, row_c, bproj, live, C, tig, a.cs);
      else
        start_sum3<NT, false>(acc, row_s, row_c, bproj, live, C, tig, a.cs);
    }
    const bf16* o_lane =
        at + (warp * 16 + 8 * (mi & 1) + r8) * kAst + 8 * (mi >> 1);
    const int p_off = (8 * (mi & 1) + r8) * kAst + 8 * (mi >> 1);
    for (int t = 0; t < proj_steps; ++t) {
      // step t's copies have landed; every warp is past step t - 1, whose
      // stage the copies of step t + kStages - 1 take
      mma::cp_async_wait<kStages - 2>();
      __syncthreads();
      load_proj(t + kStages - 1, (t + kStages - 1) % kStages);
      const bf16* ps = reinterpret_cast<const bf16*>(
                           stages + (t % kStages) * kStageBytes) +
                       p_off;
#pragma unroll
      for (int q = 0; q < kProjStep / 16; ++q) {
        uint32_t af[4];
        mma::ldsm_x4(af, o_lane + t * kProjStep + q * 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          mma::ldsm_x4_trans(b, ps + 16 * q * kAst + np * 16);
          mma::mma_bf16(acc[2 * np], af, b[0], b[1]);
          mma::mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
        }
      }
    }
    // every stage is free for the MLP's steps, and the warp's own A rows
    // take LN2(x) below
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  // the first steps' weights come while the prologue reads the rows
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) load(p, p);

  // prologue: x of the warp's rows (fused_hab_block's is in the
  // accumulators already)
  if constexpr (!HAB) {
    const bf16* row_s[2];
    const bf16* row_a[2];
    const bf16* row_c[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = row0 + warp * 16 + gid + 8 * h;
      live[h] = p < a.m;
      long long px = live[h] ? p : 0, pa = px;
      if (a.ss && live[h]) {
        const int x = static_cast<int>(p % a.W);
        const long long t = p / a.W;
        const int y = static_cast<int>(t % a.H);
        const long long b = t / a.H;
        const int ya = ((y - a.ss) % a.H + a.H) % a.H;
        const int xa = ((x - a.ss) % a.W + a.W) % a.W;
        pa = (b * a.H + ya) * a.W + xa;
      }
      row_s[h] = a.s + px * C;
      row_a[h] = a.sum3 ? a.a + pa * C : a.s;
      row_c[h] = a.sum3 ? a.cv + px * C : a.s;
    }
    // one branch for the whole read: the loads of a form follow each other
    if (a.sum3) {
      if (a.pairs)
        read_x<NT, true, true>(acc, row_s, row_a, row_c, live, C, tig, a.cs);
      else
        read_x<NT, true, false>(acc, row_s, row_a, row_c, live, C, tig, a.cs);
    } else if (a.pairs) {
      read_x<NT, false, true>(acc, row_s, row_a, row_c, live, C, tig, a.cs);
    } else {
      read_x<NT, false, false>(acc, row_s, row_a, row_c, live, C, tig, a.cs);
    }
  }
  // LayerNorm statistics of the two rows over the float32 x, each row's
  // channels spread over its quad of lanes: mean, then centred squares
  float mu[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) sum += acc[j][2 * h] + acc[j][2 * h + 1];
    mu[h] = mma::quad_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * tig;
      const float d0 = c < C ? acc[j][2 * h] - mu[h] : 0.f;
      const float d1 = c + 1 < C ? acc[j][2 * h + 1] - mu[h] : 0.f;
      sq += d0 * d0 + d1 * d1;
    }
    rstd[h] = rsqrtf(mma::quad_sum(sq) / C + a.eps);
  }
  // LN(x) rounded to bf16 into the warp's rows of the A tile, then the
  // ones column and zeros, and the accumulators start at rs * x + b2
  bf16* arow = at + (warp * 16 + gid) * kAst;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * tig;
    const bool ok0 = c < C, ok1 = c + 1 < C;
    const float2 g = pair_at<false>(a.gamma + c, ok0, ok1);
    const float2 be = pair_at<false>(a.beta + c, ok0, ok1);
    const float2 b2 = pair_at<false>(a.b2 + c, ok0, ok1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
      const float y0 = (x0 - mu[h]) * rstd[h] * g.x + be.x;
      const float y1 = (x1 - mu[h]) * rstd[h] * g.y + be.y;
      *reinterpret_cast<uint32_t*>(arow + 8 * h * kAst + c) =
          mma::pack(ok0 ? y0 : c == C ? 1.f : 0.f,
                    ok1 ? y1 : c + 1 == C ? 1.f : 0.f);
      acc[j][2 * h] = a.rs * x0 + b2.x;
      acc[j][2 * h + 1] = a.rs * x1 + b2.y;
    }
  }

  // the lane's ldmatrix rows: of its warp's 16 A rows, of a 16-row weight
  // slab
  const bf16* a_lane =
      at + (warp * 16 + 8 * (mi & 1) + r8) * kAst + 8 * (mi >> 1);
  const int w_off = (8 * (mi & 1) + r8) * kW1Stride + 8 * (mi >> 1);
  const int w2_off = (8 * (mi & 1) + r8) * kAst + 8 * (mi >> 1);
  // fc1 + b1 of step t: the warp's 16 rows by the panel's hidden columns
  float hs[kHidPanel / 8][4];
  auto fc1 = [&](int t) {
    const bf16* w1s =
        reinterpret_cast<const bf16*>(stages + (t % kStages) * kStageBytes) +
        w_off;
#pragma unroll
    for (int j = 0; j < kHidPanel / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t af[4];
      mma::ldsm_x4(af, a_lane + kk * 16);
#pragma unroll
      for (int np = 0; np < kHidPanel / 16; ++np) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, w1s + kk * 16 * kW1Stride + np * 16);
        mma::mma_bf16(hs[2 * np], af, b[0], b[1]);
        mma::mma_bf16(hs[2 * np + 1], af, b[2], b[3]);
      }
    }
  };
  // step 0's fc1 before the loop: step t's then overlaps step t - 1's GELU
  // and fc2 (no branch between them)
  mma::cp_async_wait<kStages - 2>();
  __syncthreads();
  fc1(0);
  for (int t = 0; t < steps; ++t) {
    // step t + 1's copies have landed; every warp is past step t - 1,
    // whose stage the copies of step t + kStages - 1 take
    mma::cp_async_wait<kStages - 3>();
    __syncthreads();
    load(t + kStages - 1, (t + kStages - 1) % kStages);
    // GELU, rounded to bf16: the m16n8 sums of n8 tiles 2q, 2q + 1 are the
    // A fragment of fc2's 16-deep step q
    uint32_t gf[kHidPanel / 16][4];
#pragma unroll
    for (int q = 0; q < kHidPanel / 16; ++q)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * q + u;
        gf[q][2 * u] = mma::pack(gelu_as(hs[i][0]), gelu_as(hs[i][1]));
        gf[q][2 * u + 1] = mma::pack(gelu_as(hs[i][2]), gelu_as(hs[i][3]));
      }
    // the next step's fc1 (past the last step, on a stage whose result
    // goes unused)
    fc1(t + 1);
    // fc2: the panel's W2 rows into the C-wide accumulators
    const bf16* w2s = reinterpret_cast<const bf16*>(
                          stages + (t % kStages) * kStageBytes + kW1Bytes) +
                      w2_off;
#pragma unroll
    for (int q = 0; q < kHidPanel / 16; ++q)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, w2s + 16 * q * kAst + np * 16);
        mma::mma_bf16(acc[2 * np], gf[q], b[0], b[1]);
        mma::mma_bf16(acc[2 * np + 1], gf[q], b[2], b[3]);
      }
  }

  // epilogue: panels of kPanel channels through the warp's staged tile,
  // in the stages every warp is done with
  mma::cp_async_wait<0>();
  __syncthreads();
  bf16* tile = reinterpret_cast<bf16*>(stages) + warp * 16 * mma::kRowsStride;
  mma::RowsOut dst = a.out;
  dst.row0 = row0;
  static_assert(kW % mma::kPanel == 0, "whole panels");
#pragma unroll
  for (int pn = 0; pn < kW / mma::kPanel; ++pn) {
#pragma unroll
    for (int jj = 0; jj < mma::kPanel / 8; ++jj) {
      const int j = pn * (mma::kPanel / 8) + jj;
      uint32_t* t0 = reinterpret_cast<uint32_t*>(
          tile + gid * mma::kRowsStride + jj * 8 + 2 * tig);
      t0[0] = mma::pack(acc[j][0], acc[j][1]);
      t0[8 * mma::kRowsStride / 2] = mma::pack(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    // width(C) - 64 < C: every panel holds channels
    mma::write_rows(tile, dst, warp * 16, pn * mma::kPanel,
                    min(mma::kPanel, C - pn * mma::kPanel), C);
    __syncwarp();
  }
}

template <int NT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mma_mlp_tail_kernel(TailArgs a) {
  tail_rows<NT, false>(a, nullptr, nullptr, false);
}

// fused_hab_block's tail: the head concat (a.a) through the output
// projection, the 3-way sum, then mma_mlp_tail_kernel's steps.
struct HabTailArgs {
  TailArgs t;  // sum3 with a the (m, C) head concat, ss 0, rs 1
  const bf16* wproj;  // (C, C)
  const bf16* bproj;
  bool vec_o;  // 8-byte copies of the concat's rows
};

template <int NT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    mma_hab_tail_kernel(HabTailArgs h) {
  tail_rows<NT, true>(h.t, h.wproj, h.bproj, h.vec_o);
}

template <int NT>
cudaError_t launch_nt(const TailArgs& a, int blocks, int smem,
                      cudaStream_t stream) {
  cudaError_t err = srk::set_smem(mma_mlp_tail_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  mma_mlp_tail_kernel<NT><<<blocks, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_hab_nt(const HabTailArgs& h, int blocks, int smem,
                          cudaStream_t stream) {
  cudaError_t err = srk::set_smem(mma_hab_tail_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  mma_hab_tail_kernel<NT><<<blocks, kBlockThreads, smem, stream>>>(h);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_mlp_tail's. a and cv are read only when sum3 != 0. Returns the
// cudaError_t of the launch.
extern "C" int sr_mlp_tail(int dtype, const void* s, const void* a,
                           const void* cv, const void* gamma, const void* beta,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int B, int H, int W,
                           int C, int hid, int sum3, int ss, float cs,
                           float eps, float rs, void* stream) {
  if (dtype != 0 || bad_shape(B, H, W, C, hid, sum3, ss))
    return cudaErrorInvalidValue;
  return launch<float>(s, a, cv, gamma, beta, w1, b1, w2, b2, out, B, H, W, C,
                       hid, sum3, ss, cs, eps, rs,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the tensor-core kernel needs at
// width C (any hidden width); the wrapper holds this against the card's
// limit before it launches.
extern "C" int sr_mma_mlp_tail_smem(int C) { return tc::smem_bytes(C); }

// The MLP tail in bf16 on the tensor cores: operands as sr_mlp_tail's, all
// bf16; C up to tc::kMaxWidth - 1. Returns the cudaError_t of the launch.
extern "C" int sr_mma_mlp_tail(const void* s, const void* a, const void* cv,
                               const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int B, int H, int W,
                               int C, int hid, int sum3, int ss, float cs,
                               float eps, float rs, void* stream) {
  namespace mma = srk::mma;
  using bf16 = __nv_bfloat16;
  if (bad_shape(B, H, W, C, hid, sum3, ss) || tc::width(C) > tc::kMaxWidth ||
      (sum3 && (a == nullptr || cv == nullptr)))
    return cudaErrorInvalidValue;
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto aligned4 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
  };
  auto aligned16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  auto aligned8 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
  };
  const long long m = static_cast<long long>(B) * H * W;
  tc::TailArgs t;
  t.s = b16(s);
  t.a = b16(a);
  t.cv = b16(cv);
  t.gamma = b16(gamma);
  t.beta = b16(beta);
  t.w1 = b16(w1);
  t.b1 = b16(b1);
  t.w2 = b16(w2);
  t.b2 = b16(b2);
  t.out = mma::rows_out(out, m, C);
  t.m = m;
  t.H = H;
  t.W = W;
  t.C = C;
  t.hid = hid;
  t.sum3 = sum3;
  t.ss = ss;
  t.cs = cs;
  t.eps = eps;
  t.rs = rs;
  // W1's rows (and b1) in 16-byte pieces where hid is a multiple of 8,
  // W2's in 8-byte pieces where C is a multiple of 4
  t.pairs = C % 2 == 0 && aligned4(s) &&
            (!sum3 || (aligned4(a) && aligned4(cv)));
  t.vec_w1 = hid % 8 == 0 && aligned16(w1) && aligned16(b1);
  t.vec_w2 = C % 4 == 0 && aligned8(w2);
  const int blocks =
      static_cast<int>((m + tc::kBlockRows - 1) / tc::kBlockRows);
  const int smem = tc::smem_bytes(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::width(C)) {
    case 64:
      return tc::launch_nt<8>(t, blocks, smem, st);
    case 128:
      return tc::launch_nt<16>(t, blocks, smem, st);
    case 192:
      return tc::launch_nt<24>(t, blocks, smem, st);
    default:
      return tc::launch_nt<32>(t, blocks, smem, st);
  }
}

// fused_hab_block's tail in bf16 on the tensor cores (sr_mma_hab_block's
// third launch, hab_block.cu): out = x + fc2(gelu(fc1(LN2(x)))), x = s +
// (o Wproj + bproj) + cs * cv in float32, o the (B, H, W, C) head concat;
// the other operands as sr_mma_mlp_tail's, all bf16; C up to
// tc::kMaxWidth - 1; the shared memory is sr_mma_mlp_tail_smem's. Returns
// the cudaError_t of the launch.
extern "C" int sr_mma_hab_tail(const void* s, const void* o, const void* cv,
                               const void* wproj, const void* bproj,
                               const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int B, int H,
                               int W, int C, int hid, float cs, float eps,
                               void* stream) {
  using bf16 = __nv_bfloat16;
  if (bad_shape(B, H, W, C, hid, 1, 0) || tc::width(C) > tc::kMaxWidth)
    return cudaErrorInvalidValue;
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto aligned = [](const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  const long long m = static_cast<long long>(B) * H * W;
  tc::HabTailArgs h;
  tc::TailArgs& t = h.t;
  t.s = b16(s);
  t.a = b16(o);
  t.cv = b16(cv);
  t.gamma = b16(gamma);
  t.beta = b16(beta);
  t.w1 = b16(w1);
  t.b1 = b16(b1);
  t.w2 = b16(w2);
  t.b2 = b16(b2);
  t.out = srk::mma::rows_out(out, m, C);
  t.m = m;
  t.H = H;
  t.W = W;
  t.C = C;
  t.hid = hid;
  t.sum3 = 1;
  t.ss = 0;
  t.cs = cs;
  t.eps = eps;
  t.rs = 1.f;
  t.pairs = C % 2 == 0 && aligned(s, 4) && aligned(cv, 4);
  t.vec_w1 = hid % 8 == 0 && aligned(w1, 16) && aligned(b1, 16);
  // W2's and Wproj's rows in 8-byte pieces where C is a multiple of 4
  t.vec_w2 = C % 4 == 0 && aligned(w2, 8) && aligned(wproj, 8);
  h.wproj = b16(wproj);
  h.bproj = b16(bproj);
  h.vec_o = C % 4 == 0 && aligned(o, 8);
  const int blocks =
      static_cast<int>((m + tc::kBlockRows - 1) / tc::kBlockRows);
  const int smem = tc::smem_bytes(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::width(C)) {
    case 64:
      return tc::launch_hab_nt<8>(h, blocks, smem, st);
    case 128:
      return tc::launch_hab_nt<16>(h, blocks, smem, st);
    case 192:
      return tc::launch_hab_nt<24>(h, blocks, smem, st);
    default:
      return tc::launch_hab_nt<32>(h, blocks, smem, st);
  }
}
