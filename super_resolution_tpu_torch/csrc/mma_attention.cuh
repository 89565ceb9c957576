// Window attention with a dense float32 bias on Hopper's tensor cores, in
// bf16: the tile of the bf16 kernels of window_attention.cu
// (fused_attention) and large_window_attention.cu (msa_flash_attention).
//
//   o = softmax(q k^T * scale + bias[h]) v  per (window, head),
//   q (Nq x d), k and v (Nk x d) in bf16, bias (heads, Nq, Nk) float32
//
// Replaces, with the kernels that include it, the TPU kernels of
// super_resolution_tpu/ops/pallas_attention.py: fused_attention (pallas_call
// at :105, kernel :48-66) and msa_flash_attention (:2124, kernel
// :1998-2031).
//
// What bounds it on the H100, at head dim 16 (d <= 16 pads to 16, <= 32 to
// 32, the pad is zero): the two products are 4 * Nq * Nk * 16 FLOP a
// (window, head) on the tensor cores, about a quarter of the time of the
// Nq * Nk exponentials on the special-function unit (16 a clock an SM,
// about 3.9 T/s on the card). ESC's chunk (100 windows, 4 heads, N 1024):
// 26.8 GFLOP, 0.027 ms at 989 TFLOP/s, against 419 M exp, about 0.11 ms.
// ESC-XL's (36 windows, 12 heads, N 2304): 147 GFLOP, 0.15 ms, against
// 2.29 G exp, about 0.59 ms. So the exp unit sets the pace, and wgmma's
// full rate would buy little: the products run on mma.sync.m16n8k16 (bf16
// operands, float32 sums), whose fragments stay in registers. The other
// floor is the bias: read whole once a (window, head) it is 400 x 4 MB =
// 1.68 GB (ESC) and 432 x 21.2 MB = 9.2 GB (ESC-XL) through the L2.
//
// Design. A block of four warps owns (a group of G = kWindowGroup windows,
// 64 query rows, one head); each warp owns 16 query rows of every window of
// the group.
// The block walks the keys in chunks of kKeyChunk. For each chunk it
// copies the (64 x chunk) float32 bias tile into shared memory once, with
// 16-byte cp.async, and all G windows use it: the bias stream through the
// L2 is divided by G. K and V of the G windows for the chunk come the same
// way; the next chunk's bias, K and V are in flight (double buffer) while
// this one is computed. Per window a warp then:
//   S = Q K^T     one k-step at d 16, two at d 32 (K through ldmatrix);
//   s * scale + bias in float32, the running maximum over the chunk (a
//                 quad of lanes shares a row), p = exp(s - m) by ex2 with
//                 log2 e folded in, rescale of the denominator and the
//                 accumulator;
//   O += P V      p rounded to bf16 and repacked in registers straight into
//                 A fragments (the accumulator layout of m16n8 is the A
//                 layout of m16k16), V through ldmatrix.trans.
// The denominator sums the unrounded p; the output is acc / l, rounded
// once: the cast points of the TPU flash kernel. (The TPU fused_attention
// normalises p before its cast; this online softmax does not.)
//
// G is 2: of 1, 2 and 4 it was the fastest for both kernels at ESC's and
// ESC-XL's shapes on an H100 (PERF.md section 6). At G 2 and d 16 ptxas
// gives 168 registers (three blocks an SM) and a stack frame of 8 to 16
// bytes of spill: the qf, o, m and l of both windows and the 32-float s
// tile of chunk_step are live together. G 4 takes 240 registers, two blocks
// an SM; a cap of 128 spills more. Both were slower. Holding s and its bf16
// repack for half a chunk at a time, with 64-key loads kept, would free
// about 16 registers a thread; it is not tried yet.
//
// Shared memory rows are padded (bias rows by 8 floats, k and v rows by 8
// bf16) so that the float2 bias reads and the ldmatrix row reads of a warp
// fall in distinct banks. The grid is (window groups, query blocks, heads),
// windows fastest: blocks that run together read the same bias rows, which
// the L2 then serves. Ragged edges: a group of fewer than G windows, Nq not
// a multiple of 64 (rows past it are computed on zeros and not stored), Nk
// not a multiple of the chunk (keys past it get s = -inf and zero k, v).
// Where d is no multiple of 8, or a row is not 16-byte aligned, the copies
// are plain loads and stores, and the bias likewise where Nk % 4 != 0.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace srk {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // four warps
constexpr int kQRows = 64;       // query rows of a block, 16 a warp
constexpr int kKeyChunk = 64;    // keys of a chunk
constexpr int kBiasPad = 8;      // floats after each bias row of a tile
constexpr int kKvPad = 8;        // bf16 after each k or v row of a tile
constexpr int kWindowGroup = 2;  // windows of a block, sharing each bias tile
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of one stage: the bias tile and k, v of the group's windows at
// padded head dim dp. Two stages make the block's dynamic shared memory.
__host__ __device__ constexpr int stage_bytes(int dp) {
  return 4 * kQRows * (kKeyChunk + kBiasPad) +
         2 * 2 * kWindowGroup * kKeyChunk * (dp + kKvPad);
}

__host__ __device__ constexpr int smem_bytes(int dp) {
  return 2 * stage_bytes(dp);
}

// Whether a pointer may be the source of 16-byte copies.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !ok (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (x = -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two values as bf16x2, the lower column in the lower half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One chunk of keys for one window, by one warp: its 16 query rows (A
// fragments qf) against the chunk's k and v tiles (ks, vs: kKeyChunk rows
// of DP + kKvPad bf16) with the bias of its rows gid and gid + 8 (b0, b1).
// kc: the chunk's valid keys; MASK: kc < kKeyChunk. m, l: running maximum
// and this lane's share of the denominator of rows gid and gid + 8.
template <int DP, bool MASK>
__device__ __forceinline__ void chunk_step(const uint32_t (&qf)[DP / 16][4],
                                           const bf16* ks, const bf16* vs,
                                           const float* b0, const float* b1,
                                           int kc, float scale,
                                           float (&o)[DP / 8][4],
                                           float (&m)[2], float (&l)[2]) {
  constexpr int KC = kKeyChunk, KST = DP + kKvPad;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  float s[KC / 8][4];
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // ldmatrix x4 on k: matrices (keys +0, dims +0), (+0, +8), (+8, +0),
  // (+8, +8): the b0, b1 fragments of two 8-key tiles
#pragma unroll
  for (int kt = 0; kt < DP / 16; ++kt)
#pragma unroll
    for (int jp = 0; jp < KC / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + (jp * 16 + 8 * (mi >> 1) + r8) * KST + kt * 16 +
                     8 * (mi & 1));
      mma_bf16(s[2 * jp], qf[kt], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kt], b[2], b[3]);
    }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    const float2 ba = *reinterpret_cast<const float2*>(b0 + col);
    const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
    s[j][0] = fmaf(s[j][0], scale, ba.x);
    s[j][1] = fmaf(s[j][1], scale, ba.y);
    s[j][2] = fmaf(s[j][2], scale, bb.x);
    s[j][3] = fmaf(s[j][3], scale, bb.y);
    if (MASK) {
      if (col >= kc) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= kc) s[j][1] = s[j][3] = -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m[0], quad_max(mx0));
  const float mn1 = fmaxf(m[1], quad_max(mx1));
  // log2 e folded into the exponent; a row with no key yet keeps base 0
  const float base0 = mn0 == -INFINITY ? 0.f : mn0 * kLog2e;
  const float base1 = mn1 == -INFINITY ? 0.f : mn1 * kLog2e;
  const float al0 = ex2(m[0] * kLog2e - base0);  // 0 on the first chunk
  const float al1 = ex2(m[1] * kLog2e - base1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
  uint32_t pf[KC / 16][4];
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const float p0 = ex2(fmaf(s[j][0], kLog2e, -base0));
    const float p1 = ex2(fmaf(s[j][1], kLog2e, -base0));
    const float p2 = ex2(fmaf(s[j][2], kLog2e, -base1));
    const float p3 = ex2(fmaf(s[j][3], kLog2e, -base1));
    sum0 += p0 + p1;
    sum1 += p2 + p3;
    // the accumulator tiles 2t, 2t + 1 are the A fragment of key step t
    pf[j / 2][(j & 1) * 2] = pack(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack(p2, p3);
  }
  l[0] = l[0] * al0 + sum0;
  l[1] = l[1] * al1 + sum1;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[n][0] *= al0;
    o[n][1] *= al0;
    o[n][2] *= al1;
    o[n][3] *= al1;
  }
  // ldmatrix x4 .trans on v: matrices (keys +0, dims +0), (+8, +0),
  // (+0, +8), (+8, +8): the b0, b1 fragments of two 8-dim tiles
#pragma unroll
  for (int t = 0; t < KC / 16; ++t)
#pragma unroll
    for (int up = 0; up < DP / 16; ++up) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (t * 16 + 8 * (mi & 1) + r8) * KST + up * 16 +
                           8 * (mi >> 1));
      mma_bf16(o[2 * up], pf[t], b[0], b[1]);
      mma_bf16(o[2 * up + 1], pf[t], b[2], b[3]);
    }
}

// The whole block: grid (ceil(windows / kWindowGroup), ceil(nq / 64),
// heads).
// Rows P gives the layout of q, k, v and out:
//   P::Win win(int w, int h)                        a window's handle
//   const bf16* row(const Win&, int part, int i)    part 0 q, 1 k, 2 v
//   bf16* out_row(const Win&, int i)
// vec_kv: d == DP and every k and v row 16-byte aligned; vec_bias: the bias
// rows 16-byte aligned (nk % 4 == 0).
template <int DP, typename P>
__device__ __forceinline__ void attention_block(const P& rows,
                                                const float* __restrict__ bias,
                                                int n_windows, int nq, int nk,
                                                int d, float scale,
                                                bool vec_kv, bool vec_bias) {
  constexpr int G = kWindowGroup;
  constexpr int KC = kKeyChunk, KST = DP + kKvPad, BST = KC + kBiasPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w0 = blockIdx.x * G;
  const int nwin = min(G, n_windows - w0);
  const int q0 = blockIdx.y * kQRows;
  const int h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float* bias_h = bias + static_cast<long long>(h) * nq * nk;

  typename P::Win win[G];
#pragma unroll
  for (int g = 0; g < G; ++g) win[g] = rows.win(w0 + min(g, nwin - 1), h);

  auto bias_tile = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * stage_bytes(DP));
  };
  auto kv_tile = [&](int st, int g, int part) {  // part 0 k, 1 v
    return reinterpret_cast<bf16*>(smem_raw + st * stage_bytes(DP) +
                                   4 * kQRows * BST) +
           (2 * g + part) * KC * KST;
  };

  auto load_chunk = [&](int c, int st) {
    const int c0 = c * KC;
    float* bs = bias_tile(st);
    if (vec_bias) {
      for (int e = tid; e < kQRows * KC / 4; e += kThreads) {
        const int r = e / (KC / 4), col = (e % (KC / 4)) * 4;
        const bool ok = q0 + r < nq && c0 + col < nk;
        cp_async16(bs + r * BST + col,
                   ok ? bias_h + static_cast<long long>(q0 + r) * nk + c0 + col
                      : bias,
                   ok);
      }
    } else {
      for (int e = tid; e < kQRows * KC; e += kThreads) {
        const int r = e / KC, col = e % KC;
        bs[r * BST + col] =
            (q0 + r < nq && c0 + col < nk)
                ? bias_h[static_cast<long long>(q0 + r) * nk + c0 + col]
                : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nwin) break;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        bf16* dst = kv_tile(st, g, part);
        if (vec_kv) {
          for (int e = tid; e < KC * (DP / 8); e += kThreads) {
            const int j = e / (DP / 8), piece = (e % (DP / 8)) * 8;
            const bool ok = c0 + j < nk;
            cp_async16(dst + j * KST + piece,
                       rows.row(win[g], part + 1, ok ? c0 + j : 0) + piece,
                       ok);
          }
        } else {
          for (int e = tid; e < KC * DP; e += kThreads) {
            const int j = e / DP, t = e % DP;
            dst[j * KST + t] = (c0 + j < nk && t < d)
                                   ? rows.row(win[g], part + 1, c0 + j)[t]
                                   : __float2bfloat16(0.f);
          }
        }
      }
    }
  };

  // Q of the warp's rows as A fragments, zero past nq and d
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;
  uint32_t qf[G][DP / 16][4];
  float o[G][DP / 8][4];
  float m[G][2], l[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bf16* qa = (g < nwin && r0 < nq) ? rows.row(win[g], 0, r0) : nullptr;
    const bf16* qb = (g < nwin && r1 < nq) ? rows.row(win[g], 0, r1) : nullptr;
    auto at = [&](const bf16* row, int t) {
      return (row != nullptr && t < d) ? row[t] : __float2bfloat16(0.f);
    };
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      const int c = kt * 16 + 2 * tig;
      qf[g][kt][0] = pack(at(qa, c), at(qa, c + 1));
      qf[g][kt][1] = pack(at(qb, c), at(qb, c + 1));
      qf[g][kt][2] = pack(at(qa, c + 8), at(qa, c + 9));
      qf[g][kt][3] = pack(at(qb, c + 8), at(qb, c + 9));
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[g][n][e] = 0.f;
    m[g][0] = m[g][1] = -INFINITY;
    l[g][0] = l[g][1] = 0.f;
  }

  const int chunks = (nk + KC - 1) / KC;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    // the stage of chunk c + 1 was last read in chunk c - 1, which ended
    // with a block barrier
    if (c + 1 < chunks) {
      load_chunk(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = c & 1;
    const int kc = min(KC, nk - c * KC);
    const float* b0 = bias_tile(st) + (warp * 16 + gid) * BST;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nwin) break;
      if (kc == KC)
        chunk_step<DP, false>(qf[g], kv_tile(st, g, 0), kv_tile(st, g, 1), b0,
                              b0 + 8 * BST, kc, scale, o[g], m[g], l[g]);
      else
        chunk_step<DP, true>(qf[g], kv_tile(st, g, 0), kv_tile(st, g, 1), b0,
                             b0 + 8 * BST, kc, scale, o[g], m[g], l[g]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= nwin) break;
    const float l0 = quad_sum(l[g][0]), l1 = quad_sum(l[g][1]);
    bf16* oa = r0 < nq ? rows.out_row(win[g], r0) : nullptr;
    bf16* ob = r1 < nq ? rows.out_row(win[g], r1) : nullptr;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= d) continue;
        if (oa != nullptr) oa[col + e] = __float2bfloat16(o[g][n][e] / l0);
        if (ob != nullptr) ob[col + e] = __float2bfloat16(o[g][n][2 + e] / l1);
      }
    }
  }
}

}  // namespace mma
}  // namespace srk
