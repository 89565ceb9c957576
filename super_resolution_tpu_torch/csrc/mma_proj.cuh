// Row-block projections on Hopper's tensor cores, bf16 operands and
// float32 sums: a block of kProjWarps warps owns 16 rows each of an
// activation (pixels of an NHWC image) and multiplies them by a weight laid
// out (in, out), the products on mma.sync.m16n8k16, into rows of a
// row-major matrix. The parts of the kernels that wrap an attention
// between two projections (ocab_block.cu: mma_ln_proj_kernel,
// mma_proj_residual_kernel; msa_block.cu: mma_proj_bias_kernel):
//
//   stage_rows   the block's rows of A, whole, into an A tile (K rounded
//                up to 16, zero past K and past the last row);
//   layer_norm_rows  a warp's 16 rows of the A tile normalised in place,
//                statistics in float32 in two passes, the result rounded
//                to bf16 (the LayerNorm before a projection);
//   project_rows A tile times the weight: panels of kPanel output columns,
//                each summed over slabs of kSlab weight rows, a slab's
//                copies in flight while the slab before is multiplied;
//                value(row, col, v0, v1, word) turns the float32 sums of
//                columns col, col + 1 of a row into their bf16 pair, which
//                goes through the weight stage the panel has just finished
//                with; a warp writes its 16 rows' segments of the panel in
//                pieces of up to 16 bytes (rows_out picks the piece).
//
// What bounds them: a projection of M rows by a (K, N) weight is 2 M K N
// FLOP against 2 M (K + N) bytes of bf16 activations, K N / (K + N) FLOP a
// byte: 90 to 135 at the OCAB's K, N of 180 to 540, below the H100's 295,
// so bytes bound them; the weight (at most 200 kB) comes from the L2 to
// every block.
// The A tile stays in shared memory for all panels, so the activation is
// read once; a step takes a whole panel of the weight (K up to kSlab). A
// warp owns 16 rows, so the LayerNorm of a row needs no block barrier. The
// loads an epilogue adds (biases, the residual) are all issued before its
// first store. 8 warps with whole panels and 4 with slabs of 64 rows were
// level at the OCAB's chunk on an H100, 4 with whole panels slower
// (PERF.md section 6); all run far below the bytes' rate, most of their
// time in the epilogue's stores and the serial LayerNorm of a warp's rows.
// The stores are staged: a block's rows are contiguous pixels, so a warp's
// segment of a panel is 16 runs of 128 bytes, written with 8-byte stores
// (16 where a row is a multiple of 8 values) in whole sectors; scattered
// 4-byte stores of the fragments' pairs were 6-7% slower a projection.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_attention.cuh"

namespace srk {
namespace mma {

constexpr int kProjWarps = 8;                 // warps of a block
constexpr int kProjRows = 16 * kProjWarps;    // rows of a block, 16 a warp
constexpr int kProjThreads = 32 * kProjWarps;
constexpr int kSlab = 192;      // weight rows of a step: K up to 192 whole
constexpr int kPanel = 64;      // output columns of a panel
constexpr int kProjPad = 8;     // bf16 after each row of a tile

// Row stride (bf16) of the A tile for K columns: K rounded up to 16, plus
// kProjPad.
__host__ __device__ constexpr int a_stride(int k) {
  return (k + 15) / 16 * 16 + kProjPad;
}

// One stage of weight: a slab of kSlab rows by kPanel columns, rows padded.
__host__ __device__ constexpr int w_stage_bytes() {
  return 2 * kSlab * (kPanel + kProjPad);
}

// The A tile and two weight stages.
__host__ __device__ constexpr int proj_smem_bytes(int k) {
  return 2 * kProjRows * a_stride(k) + 2 * w_stage_bytes();
}

// Rows row0 .. row0 + kProjRows - 1 of the (m x ld) matrix a, columns 0 ..
// k - 1, into the A tile at, zero past k (up to the tile's width) and past
// m. vec: k and ld multiples of 4 and a 8-byte aligned (8-byte cp.async),
// else plain loads. Not committed: the caller commits the group.
__device__ __forceinline__ void stage_rows(bf16* at, const bf16* a, int ld,
                                           long long row0, long long m,
                                           int k, bool vec) {
  const int ast = a_stride(k), kp = ast - kProjPad;
  if (vec) {
    for (int e = threadIdx.x; e < kProjRows * kp / 4; e += kProjThreads) {
      const int r = e / (kp / 4), c = (e % (kp / 4)) * 4;
      const bool ok = row0 + r < m && c < k;
      cp_async8(at + r * ast + c, ok ? a + (row0 + r) * ld + c : a, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < kProjRows * kp; e += kProjThreads) {
      const int r = e / kp, c = e % kp;
      at[r * ast + c] =
          (row0 + r < m && c < k) ? a[(row0 + r) * ld + c] : zero;
    }
  }
}

// LayerNorm of the calling warp's 16 rows of the A tile (k values a row),
// in place: (x - mean) * rsqrt(var + eps) * gamma + beta in float32, both
// statistics over the row in two passes, rounded to bf16 once. The columns
// past k stay zero.
__device__ __forceinline__ void layer_norm_rows(bf16* at, int k,
                                               const bf16* gamma,
                                               const bf16* beta, float eps) {
  const int ast = a_stride(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < 16; ++i) {
    bf16* rw = at + (warp * 16 + i) * ast;
    float mu, rstd;
    warp_ln_stats([&](int c) { return __bfloat162float(rw[c]); }, k, eps, mu,
                  rstd);
    for (int c = lane; c < k; c += 32)
      rw[c] = __float2bfloat16((__bfloat162float(rw[c]) - mu) * rstd *
                                   __bfloat162float(gamma[c]) +
                               __bfloat162float(beta[c]));
  }
  __syncwarp();
}

// Where project_rows writes: rows row0 .. of a row-major (m x ld) bf16
// matrix at base, in pieces of `piece` bytes (16, 8, 4 or 2: a divisor of
// 2 ld, of 2 kPanel and of base's alignment).
struct RowsOut {
  bf16* base;
  long long row0, m;
  int piece;
};

// The RowsOut of the (m x n) matrix at base (row0 is the block's to set):
// the largest piece that divides a row's bytes and base's alignment (a
// panel's 2 kPanel bytes are a multiple of 16).
inline RowsOut rows_out(void* base, long long m, int n) {
  RowsOut o{static_cast<bf16*>(base), 0, m, 2};
  const auto addr = reinterpret_cast<uintptr_t>(base);
  for (int piece = 16; piece > 2; piece /= 2)
    if ((2 * n) % piece == 0 && addr % piece == 0) {
      o.piece = piece;
      break;
    }
  return o;
}

// Row stride (bf16) of a warp's staged 16 x kPanel tile, padded so that the
// lanes' 4-byte pairs of a fragment fall in distinct banks.
constexpr int kRowsStride = kPanel + kProjPad;
static_assert(kProjWarps * 16 * kRowsStride * 2 <= w_stage_bytes(),
              "the staged tiles fit in a weight stage");

// One piece of `bytes` bytes, shared -> global.
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int bytes) {
  switch (bytes) {
    case 16:
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      break;
    case 8:
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
      break;
    default:
      *reinterpret_cast<bf16*>(dst) = *reinterpret_cast<const bf16*>(src);
  }
}

// The calling warp's staged tile (16 rows of kRowsStride) to rows r0 ..
// r0 + 15 of its block, columns c0 .. c0 + nc - 1 of an ld-column matrix:
// each row's segment is contiguous, and the lanes take its pieces in turn,
// so a store instruction covers whole runs of a row.
__device__ __forceinline__ void write_rows(const bf16* tile,
                                           const RowsOut& dst, int r0,
                                           int c0, int nc, int ld) {
  const int lane = threadIdx.x & 31;
  const int per_row = nc * 2 / dst.piece;
  for (int e = lane; e < 16 * per_row; e += 32) {
    const int i = e / per_row, q = e % per_row;
    const long long row = dst.row0 + r0 + i;
    if (row >= dst.m) continue;
    copy_piece(reinterpret_cast<unsigned char*>(dst.base + row * ld + c0) +
                   q * dst.piece,
               reinterpret_cast<const unsigned char*>(tile + i * kRowsStride) +
                   q * dst.piece,
               dst.piece);
  }
}

// acc += the warp's 16 rows of the A tile (columns a0 .. a0 + 16 ksteps)
// times a staged weight slab.
__device__ __forceinline__ void project_slab(const bf16* a, int ast, int a0,
                                             const bf16* wsl, int ksteps,
                                             float (&acc)[kPanel / 8][4]) {
  constexpr int WST = kPanel + kProjPad;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kSlab / 16; ++kk) {
    if (kk >= ksteps) break;
    uint32_t af[4];
    ldsm_x4(af, a + (8 * (mi & 1) + r8) * ast + a0 + kk * 16 + 8 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < kPanel / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, wsl + (kk * 16 + 8 * (mi & 1) + r8) * WST + np * 16 +
                           8 * (mi >> 1));
      mma_bf16(acc[2 * np], af, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// The A tile at (k columns, staged by stage_rows with its copies not yet
// committed: the first step's commit takes them) times a (k, n) weight
// whose row r, columns c .. c + 3 start at w_at(r, c), into rows dst.row0 ..
// of a row-major (dst.m x n) bf16 matrix: panels of kPanel
// output columns, each summed over slabs of kSlab weight rows (one slab
// where k <= kSlab), the next step's slab in flight while a step is
// multiplied (stages: two weight stages). vec: 8-byte copies of four
// columns (n a multiple of 4, every w_at(r, c) with c % 4 == 0 8-byte
// aligned), else plain loads of w_at(r, c)[0]. prologue() runs once, after
// the first barrier (the A tile has landed). At the end of a panel, after
// the barrier that ends its last step, the warp's pairs of output columns
// c, c + 1 (c even, c < n) of its block rows r go out in two rounds:
// fetch(r, c) returns a 32-bit word for each (a bf16 pair the store adds,
// loaded for every pair before the first store), then value(r, c, v0, v1,
// word) gets the float32 sums (v1 past n is 0) and returns their bf16 pair
// (the second past n is not written), which the warp puts in its 16-row
// tile of the weight stage the panel has just read and, after a warp
// barrier, writes to dst (write_rows); a block barrier then frees the stage
// for the copies of step t + 2. The last panel's stage is not freed: a
// caller that projects again into the same stages first waits at a block
// barrier.
template <typename WAt, typename Pro, typename Fetch, typename Value>
__device__ __forceinline__ void project_rows(const bf16* at, int k, int n,
                                             WAt w_at, bool vec,
                                             unsigned char* stages,
                                             Pro prologue, Fetch fetch,
                                             Value value,
                                             const RowsOut& dst) {
  constexpr int WST = kPanel + kProjPad;
  const int ast = a_stride(k), kp = ast - kProjPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int slabs = (kp + kSlab - 1) / kSlab;
  const int steps = slabs * ((n + kPanel - 1) / kPanel);
  auto w_slab = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * w_stage_bytes());
  };
  auto load = [&](int p, int s, int st) {
    const int k0 = s * kSlab, n0 = p * kPanel;
    const int rows = min(kSlab, kp - k0);
    bf16* wd = w_slab(st);
    if (vec) {
      for (int e = tid; e < rows * kPanel / 4; e += kProjThreads) {
        const int r = e / (kPanel / 4), c = (e % (kPanel / 4)) * 4;
        const bool ok = k0 + r < k && n0 + c < n;
        cp_async8(wd + r * WST + c, ok ? w_at(k0 + r, n0 + c) : w_at(0, 0),
                  ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < rows * kPanel; e += kProjThreads) {
        const int r = e / kPanel, c = e % kPanel;
        wd[r * WST + c] =
            (k0 + r < k && n0 + c < n) ? w_at(k0 + r, n0 + c)[0] : zero;
      }
    }
    cp_async_commit();
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) prologue();
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    const int ksteps = min(kSlab, kp - s * kSlab) / 16;
    project_slab(at + warp * 16 * ast, ast, s * kSlab, w_slab(t & 1), ksteps,
                 acc);
    __syncthreads();
    if (s == slabs - 1) {
      const int r = warp * 16 + gid;
      uint32_t word[kPanel / 8][2];
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j) {
        const int c = p * kPanel + j * 8 + 2 * tig;
        if (c >= n) continue;
        word[j][0] = fetch(r, c);
        word[j][1] = fetch(r + 8, c);
      }
      // the warp's 16 rows of the panel, in the stage this step has read
      bf16* tile = w_slab(t & 1) + warp * 16 * kRowsStride;
#pragma unroll
      for (int j = 0; j < kPanel / 8; ++j) {
        const int c = p * kPanel + j * 8 + 2 * tig;
        if (c >= n) continue;
        uint32_t* t0 = reinterpret_cast<uint32_t*>(
            tile + gid * kRowsStride + j * 8 + 2 * tig);
        t0[0] = value(r, c, acc[j][0], acc[j][1], word[j][0]);
        t0[8 * kRowsStride / 2] =
            value(r + 8, c, acc[j][2], acc[j][3], word[j][1]);
      }
      __syncwarp();
      write_rows(tile, dst, warp * 16, p * kPanel,
                 min(kPanel, n - p * kPanel), n);
      // step t + 2 copies its slab into this stage
      if (t + 2 < steps) __syncthreads();
    }
    p = np;
    s = ns;
  }
}

// A bf16 pair as floats: the low half first.
__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

}  // namespace mma
}  // namespace srk
