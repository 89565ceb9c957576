// Window attention with a dense float32 bias on Hopper's tensor cores, in
// bf16: the tile of the bf16 kernels of window_attention.cu
// (fused_attention, fused_attention_v3) and large_window_attention.cu
// (msa_flash_attention, msa_qtile_attention).
//
//   o = softmax(q k^T * scale + bias[h]) v  per (window, head),
//   q (Nq x d), k and v (Nk x d) in bf16, bias (heads, Nq, Nk) float32
//
// Replaces, with the kernels that include it, the TPU kernels of
// super_resolution_tpu/ops/pallas_attention.py: fused_attention (pallas_call
// at :105, kernel :48-66), fused_attention_v3 (:186, kernel :127-149),
// msa_qtile_attention (:1902, kernel :1797-1814), msa_flash_attention
// (:2124, kernel :1998-2031) and fused_ocab_attention (:296, kernel
// :208-231). Three blocks share the tile: attention_block (a head a block,
// online softmax: fused_attention, msa_flash_attention,
// fused_ocab_attention), head_walk_block (the same with the heads walked
// inside the block: fused_attention_v3) and exact_attention_block (a head a
// block, exact softmax in two passes: msa_qtile_attention).
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
// and fused_attention_v3 normalise p before its cast; this online softmax
// does not.) exact_attention_block keeps the TPU qtile's cast points: pass
// 1 (stats_step) finds each row's maximum and denominator, pass 2
// (normalised_step) rounds p = exp(s - m) / l, so it takes two
// exponentials a score and reads the bias twice.
//
// G is 2: of 1, 2 and 4 it was the fastest for both kernels at ESC's and
// ESC-XL's shapes on an H100 (PERF.md section 6). At G 2 and d 16 ptxas
// gives 168 registers (three blocks an SM) and a stack frame of 8 to 16
// bytes of spill: the qf, o, m and l of both windows and the 32-float s
// tile of chunk_step are live together. G 4 takes 240 registers, two blocks
// an SM; a cap of 128 spills more. Both were slower. Holding s and its bf16
// repack for half a chunk at a time, with 64-key loads kept, would free
// about 16 registers a thread; it is not tried yet. head_walk_block and
// exact_attention_block take 168 registers at d 16 without spill.
//
// Shared memory rows are padded (bias rows by 8 floats, k and v rows by 8
// bf16) so that the float2 bias reads and the ldmatrix row reads of a warp
// fall in distinct banks. The grid is (window groups, query blocks, heads),
// windows fastest: blocks that run together read the same bias rows, which
// the L2 then serves. Ragged edges: a group of fewer than G windows, Nq not
// a multiple of 64 (rows past it are computed on zeros and not stored), Nk
// not a multiple of the chunk (keys past it get s = -inf and zero k, v).
// Where d is no multiple of 8, or a row is not 16-byte aligned, the copies
// are plain loads and stores, and the bias likewise where Nk % 4 != 0. A
// layout whose rows are only 4-byte aligned (ocab_attention.cu: head slices
// of 60 bytes in 720-byte pixel rows) sets kWordCopies in its row policy:
// attention_block then copies k and v as 4-byte words (load_kv_words), and
// the other instantiations compile as before (the branch is if constexpr).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// 8 or 4 bytes global -> shared through the L1 (.ca: the only cache mode
// of copies below 16 bytes); zeros where !ok.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
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

// S = Q K^T of one chunk for one window, by one warp: its 16 query rows (A
// fragments qf) against the chunk's k tile (ks: KC rows of DP + kKvPad
// bf16), then s * scale + bias in float32 with the bias of its rows gid and
// gid + 8 (b0, b1). kc: the chunk's valid keys; MASK: kc < KC, keys past kc
// get -inf. mx0, mx1: this lane's maxima of the two rows.
template <int DP, bool MASK, int KC = kKeyChunk>
__device__ __forceinline__ void chunk_scores(const uint32_t (&qf)[DP / 16][4],
                                             const bf16* ks, const float* b0,
                                             const float* b1, int kc,
                                             float scale,
                                             float (&s)[KC / 8][4],
                                             float& mx0, float& mx1) {
  constexpr int KST = DP + kKvPad;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
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
  mx0 = -INFINITY;
  mx1 = -INFINITY;
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
}

// O += P V for one chunk: pf the bf16 A fragments of p, vs the chunk's v
// tile (KC rows of DP + kKvPad bf16).
template <int DP, int KC = kKeyChunk>
__device__ __forceinline__ void chunk_pv(const uint32_t (&pf)[KC / 16][4],
                                         const bf16* vs,
                                         float (&o)[DP / 8][4]) {
  constexpr int KST = DP + kKvPad;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, r8 = lane & 7;
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

// The exponent base of a row whose maximum is mn: mn * log2 e, with log2 e
// folded into the exponent; a row with no key yet keeps base 0.
__device__ __forceinline__ float exp_base(float mn) {
  return mn == -INFINITY ? 0.f : mn * kLog2e;
}

// One chunk of keys for one window, by one warp, online softmax: scores as
// chunk_scores, p = exp(s - m) with the running maximum m, the rescale of
// the denominator and the accumulator, O += P V with p rounded to bf16
// unnormalised. m, l: running maximum and this lane's share of the
// denominator of rows gid and gid + 8.
template <int DP, bool MASK>
__device__ __forceinline__ void chunk_step(const uint32_t (&qf)[DP / 16][4],
                                           const bf16* ks, const bf16* vs,
                                           const float* b0, const float* b1,
                                           int kc, float scale,
                                           float (&o)[DP / 8][4],
                                           float (&m)[2], float (&l)[2]) {
  constexpr int KC = kKeyChunk;
  float s[KC / 8][4];
  float mx0, mx1;
  chunk_scores<DP, MASK>(qf, ks, b0, b1, kc, scale, s, mx0, mx1);
  const float mn0 = fmaxf(m[0], quad_max(mx0));
  const float mn1 = fmaxf(m[1], quad_max(mx1));
  const float base0 = exp_base(mn0), base1 = exp_base(mn1);
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
  chunk_pv<DP>(pf, vs, o);
}

// Pass 1 of the exact softmax, one chunk: the running maximum m and this
// lane's share l of the denominator sum(exp(s - m)) of rows gid and gid + 8;
// only l is rescaled, there is no accumulator and no v. KC as chunk_scores.
template <int DP, bool MASK, int KC = kKeyChunk>
__device__ __forceinline__ void stats_step(const uint32_t (&qf)[DP / 16][4],
                                           const bf16* ks, const float* b0,
                                           const float* b1, int kc,
                                           float scale, float (&m)[2],
                                           float (&l)[2]) {
  float s[KC / 8][4];
  float mx0, mx1;
  chunk_scores<DP, MASK, KC>(qf, ks, b0, b1, kc, scale, s, mx0, mx1);
  const float mn0 = fmaxf(m[0], quad_max(mx0));
  const float mn1 = fmaxf(m[1], quad_max(mx1));
  const float base0 = exp_base(mn0), base1 = exp_base(mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    sum0 += ex2(fmaf(s[j][0], kLog2e, -base0)) +
            ex2(fmaf(s[j][1], kLog2e, -base0));
    sum1 += ex2(fmaf(s[j][2], kLog2e, -base1)) +
            ex2(fmaf(s[j][3], kLog2e, -base1));
  }
  l[0] = l[0] * ex2(m[0] * kLog2e - base0) + sum0;  // 0 * 0 on the first
  l[1] = l[1] * ex2(m[1] * kLog2e - base1) + sum1;
  m[0] = mn0;
  m[1] = mn1;
}

// Pass 2 of the exact softmax, one chunk: p = exp(s - m) / l in float32
// from each row's exponent base (exp_base of its maximum) and 1 / l, p
// rounded to bf16, O += P V. KC as chunk_scores.
template <int DP, bool MASK, int KC = kKeyChunk>
__device__ __forceinline__ void normalised_step(
    const uint32_t (&qf)[DP / 16][4], const bf16* ks, const bf16* vs,
    const float* b0, const float* b1, int kc, float scale,
    const float (&base)[2], const float (&inv)[2], float (&o)[DP / 8][4]) {
  float s[KC / 8][4];
  float mx0, mx1;
  chunk_scores<DP, MASK, KC>(qf, ks, b0, b1, kc, scale, s, mx0, mx1);
  uint32_t pf[KC / 16][4];
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const float p0 = ex2(fmaf(s[j][0], kLog2e, -base[0])) * inv[0];
    const float p1 = ex2(fmaf(s[j][1], kLog2e, -base[0])) * inv[0];
    const float p2 = ex2(fmaf(s[j][2], kLog2e, -base[1])) * inv[1];
    const float p3 = ex2(fmaf(s[j][3], kLog2e, -base[1])) * inv[1];
    pf[j / 2][(j & 1) * 2] = pack(p0, p1);
    pf[j / 2][(j & 1) * 2 + 1] = pack(p2, p3);
  }
  chunk_pv<DP, KC>(pf, vs, o);
}

// A block's stage st in dynamic shared memory: the (64 x chunk) bias tile,
// then k (part 0) and v (part 1) of each window g of the group.
template <int DP>
__device__ __forceinline__ float* bias_tile(unsigned char* smem, int st) {
  return reinterpret_cast<float*>(smem + st * stage_bytes(DP));
}

template <int DP>
__device__ __forceinline__ bf16* kv_tile(unsigned char* smem, int st, int g,
                                         int part) {
  return reinterpret_cast<bf16*>(smem + st * stage_bytes(DP) +
                                 4 * kQRows * (kKeyChunk + kBiasPad)) +
         (2 * g + part) * kKeyChunk * (DP + kKvPad);
}

// The copies of the chunk of keys from c0 into stage st, by the whole block:
// rows q0 .. q0 + 63 of the head's bias bias_h (zero past nq and nk) and
// PARTS of k, v (k alone for 1) of the group's nwin windows (zero past
// nk and d). vec_kv, vec_bias: 16-byte cp.async, else plain loads.
template <int DP, int PARTS, typename P>
__device__ __forceinline__ void load_stage(
    unsigned char* smem, int st, const P& rows,
    const typename P::Win (&win)[kWindowGroup], int nwin,
    const float* bias_h, int q0, int nq, int c0, int nk, int d, bool vec_kv,
    bool vec_bias) {
  constexpr int KC = kKeyChunk, KST = DP + kKvPad, BST = KC + kBiasPad;
  const int tid = threadIdx.x;
  float* bs = bias_tile<DP>(smem, st);
  if (vec_bias) {
    for (int e = tid; e < kQRows * KC / 4; e += kThreads) {
      const int r = e / (KC / 4), col = (e % (KC / 4)) * 4;
      const bool ok = q0 + r < nq && c0 + col < nk;
      cp_async16(bs + r * BST + col,
                 bias_h + (ok ? static_cast<long long>(q0 + r) * nk + c0 + col
                              : 0),
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
  for (int g = 0; g < kWindowGroup; ++g) {
    if (g >= nwin) break;
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      bf16* dst = kv_tile<DP>(smem, st, g, part);
      if (vec_kv) {
        for (int e = tid; e < KC * (DP / 8); e += kThreads) {
          const int j = e / (DP / 8), piece = (e % (DP / 8)) * 8;
          const bool ok = c0 + j < nk;
          cp_async16(dst + j * KST + piece,
                     rows.row(win[g], part + 1, ok ? c0 + j : 0) + piece, ok);
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
}

// Q of a warp's rows r0 and r1 of window w as A fragments, zero past nq and
// d and where !ok (a window past the group's end).
template <int DP, typename P>
__device__ __forceinline__ void load_q(const P& rows, const typename P::Win& w,
                                       bool ok, int r0, int r1, int nq, int d,
                                       uint32_t (&qf)[DP / 16][4]) {
  const int tig = threadIdx.x & 3;
  const bf16* qa = (ok && r0 < nq) ? rows.row(w, 0, r0) : nullptr;
  const bf16* qb = (ok && r1 < nq) ? rows.row(w, 0, r1) : nullptr;
  auto at = [&](const bf16* row, int t) {
    return (row != nullptr && t < d) ? row[t] : __float2bfloat16(0.f);
  };
#pragma unroll
  for (int kt = 0; kt < DP / 16; ++kt) {
    const int c = kt * 16 + 2 * tig;
    qf[kt][0] = pack(at(qa, c), at(qa, c + 1));
    qf[kt][1] = pack(at(qb, c), at(qb, c + 1));
    qf[kt][2] = pack(at(qa, c + 8), at(qa, c + 9));
    qf[kt][3] = pack(at(qb, c + 8), at(qb, c + 9));
  }
}

// Rows r0 and r1 of window w's output: o / l0 and o / l1, rounded once.
template <int DP, typename P>
__device__ __forceinline__ void store_out(const P& rows,
                                          const typename P::Win& w, int r0,
                                          int r1, int nq, int d,
                                          const float (&o)[DP / 8][4],
                                          float l0, float l1) {
  const int tig = threadIdx.x & 3;
  bf16* oa = r0 < nq ? rows.out_row(w, r0) : nullptr;
  bf16* ob = r1 < nq ? rows.out_row(w, r1) : nullptr;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= d) continue;
      if (oa != nullptr) oa[col + e] = __float2bfloat16(o[n][e] / l0);
      if (ob != nullptr) ob[col + e] = __float2bfloat16(o[n][2 + e] / l1);
    }
  }
}

// Whether a row policy asks for 4-byte copies of k and v (a static member
// kWordCopies = true); false for a policy without the member.
template <typename P, typename = void>
struct word_copies : std::false_type {};
template <typename P>
struct word_copies<P, std::void_t<decltype(P::kWordCopies)>>
    : std::bool_constant<P::kWordCopies> {};

// k and v of the chunk of keys from c0 for window w into ks and vs, as
// 4-byte words (cp.async.ca): a thread takes the same word of k and of v of
// a key, so the key's row is found once for both. Words at or past d / 2
// (the pad of the head dim) and keys past nk are zero. Needs d even and
// every row 4-byte aligned.
template <int DP, typename P>
__device__ __forceinline__ void load_kv_words(const P& rows,
                                              const typename P::Win& w,
                                              bf16* ks, bf16* vs, int c0,
                                              int nk, int d) {
  constexpr int KST = DP + kKvPad, WORDS = DP / 2;
  for (int e = threadIdx.x; e < kKeyChunk * WORDS; e += kThreads) {
    const int j = e / WORDS, t = 2 * (e % WORDS);
    const bool key = c0 + j < nk;
    const bool ok = key && t < d;
    const int i = key ? c0 + j : 0;
    cp_async4(ks + j * KST + t, rows.row(w, 1, i) + t, ok);
    cp_async4(vs + j * KST + t, rows.row(w, 2, i) + t, ok);
  }
}

// A fresh online softmax: o = 0, m = -inf, l = 0.
template <int DP>
__device__ __forceinline__ void clear_rows(float (&o)[DP / 8][4],
                                           float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
}

// The whole block of fused_attention and msa_flash_attention: grid
// (ceil(windows / kWindowGroup), ceil(nq / 64), heads).
// Rows P gives the layout of q, k, v and out:
//   P::Win win(int w, int h)                        a window's handle
//   const bf16* row(const Win&, int part, int i)    part 0 q, 1 k, 2 v
//   bf16* out_row(const Win&, int i)
// vec_kv: d == DP and every k and v row 16-byte aligned (for a policy with
// kWordCopies: d even and every row 4-byte aligned); vec_bias: the bias rows
// 16-byte aligned (nk % 4 == 0).
// It writes its copies, q fragments and output itself, not through
// load_stage, load_q and store_out: through those helpers ptxas spills 32
// bytes in place of 16 at d 16 (fused_attention) and 12 in place of 8
// (msa_flash_attention).
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
      if constexpr (word_copies<P>::value) {
        if (vec_kv) {
          load_kv_words<DP>(rows, win[g], kv_tile(st, g, 0),
                            kv_tile(st, g, 1), c0, nk, d);
          continue;
        }
      }
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

// The block of fused_attention_v3: attention_block's tile and online
// softmax, with the heads walked inside the block. Grid (ceil(windows /
// kWindowGroup), ceil(nq / 64)). Steps t = h * chunks + c run head h's
// chunk c; the copies of step t + 1 are in flight while step t is
// computed, across a head boundary too (the first chunk of head h + 1
// arrives while the last of head h is computed). Each head loads its q
// fragments at its first step and writes its output after its last.
template <int DP, typename P>
__device__ __forceinline__ void head_walk_block(const P& rows,
                                                const float* __restrict__ bias,
                                                int n_windows, int heads,
                                                int nq, int nk, int d,
                                                float scale, bool vec_kv,
                                                bool vec_bias) {
  constexpr int G = kWindowGroup;
  constexpr int KC = kKeyChunk, BST = KC + kBiasPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w0 = blockIdx.x * G;
  const int nwin = min(G, n_windows - w0);
  const int q0 = blockIdx.y * kQRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;
  const int chunks = (nk + KC - 1) / KC, steps = heads * chunks;

  auto load = [&](int t) {  // the copies of step t into stage t & 1
    const int h = t / chunks;
    typename P::Win win[G];
#pragma unroll
    for (int g = 0; g < G; ++g) win[g] = rows.win(w0 + min(g, nwin - 1), h);
    load_stage<DP, 2>(smem_raw, t & 1, rows, win, nwin,
                      bias + static_cast<long long>(h) * nq * nk, q0, nq,
                      (t - h * chunks) * KC, nk, d, vec_kv, vec_bias);
    cp_async_commit();
  };

  uint32_t qf[G][DP / 16][4];
  float o[G][DP / 8][4];
  float m[G][2], l[G][2];
  load(0);
  for (int t = 0; t < steps; ++t) {
    const int h = t / chunks, c = t - h * chunks;
    // the stage of step t + 1 was last read in step t - 1, which ended with
    // a block barrier
    if (t + 1 < steps) load(t + 1);
    if (c == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load_q<DP>(rows, rows.win(w0 + min(g, nwin - 1), h), g < nwin, r0,
                   r1, nq, d, qf[g]);
        clear_rows<DP>(o[g], m[g], l[g]);
      }
    }
    if (t + 1 < steps)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int st = t & 1;
    const int kc = min(KC, nk - c * KC);
    const float* b0 = bias_tile<DP>(smem_raw, st) + (warp * 16 + gid) * BST;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nwin) break;
      const bf16* ks = kv_tile<DP>(smem_raw, st, g, 0);
      const bf16* vs = kv_tile<DP>(smem_raw, st, g, 1);
      if (kc == KC)
        chunk_step<DP, false>(qf[g], ks, vs, b0, b0 + 8 * BST, kc, scale,
                              o[g], m[g], l[g]);
      else
        chunk_step<DP, true>(qf[g], ks, vs, b0, b0 + 8 * BST, kc, scale, o[g],
                             m[g], l[g]);
    }
    __syncthreads();
    if (c == chunks - 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= nwin) break;
        store_out<DP>(rows, rows.win(w0 + g, h), r0, r1, nq, d, o[g],
                      quad_sum(l[g][0]), quad_sum(l[g][1]));
      }
    }
  }
}

// The block of msa_qtile_attention: attention_block's tile and grid with an
// exact row softmax in two passes over the key chunks. Pass 1 (steps 0 ..
// chunks - 1) stages the bias and k only and keeps each row's maximum and
// denominator (stats_step); pass 2 (steps chunks .. 2 chunks - 1) stages
// bias, k and v and accumulates P V with p normalised before it is rounded
// (normalised_step); the output is rounded once, with no division. Step t
// uses stage t & 1; the first chunk of pass 2 is in flight while the last
// of pass 1 is computed.
template <int DP, typename P>
__device__ __forceinline__ void exact_attention_block(
    const P& rows, const float* __restrict__ bias, int n_windows, int nq,
    int nk, int d, float scale, bool vec_kv, bool vec_bias) {
  constexpr int G = kWindowGroup;
  constexpr int KC = kKeyChunk, BST = KC + kBiasPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w0 = blockIdx.x * G;
  const int nwin = min(G, n_windows - w0);
  const int q0 = blockIdx.y * kQRows;
  const int h = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const float* bias_h = bias + static_cast<long long>(h) * nq * nk;
  const int chunks = (nk + KC - 1) / KC;

  typename P::Win win[G];
#pragma unroll
  for (int g = 0; g < G; ++g) win[g] = rows.win(w0 + min(g, nwin - 1), h);
  auto load = [&](int t) {  // the copies of step t into stage t & 1
    if (t < chunks)
      load_stage<DP, 1>(smem_raw, t & 1, rows, win, nwin, bias_h, q0, nq,
                        t * KC, nk, d, vec_kv, vec_bias);
    else
      load_stage<DP, 2>(smem_raw, t & 1, rows, win, nwin, bias_h, q0, nq,
                        (t - chunks) * KC, nk, d, vec_kv, vec_bias);
    cp_async_commit();
  };

  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;
  uint32_t qf[G][DP / 16][4];
  float o[G][DP / 8][4];
  float m[G][2], l[G][2];
  load(0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_q<DP>(rows, win[g], g < nwin, r0, r1, nq, d, qf[g]);
    clear_rows<DP>(o[g], m[g], l[g]);
  }

  // the stage of step t + 1 was last read in step t - 1, which ended with a
  // block barrier; pass 1 always has a next step
  for (int c = 0; c < chunks; ++c) {
    load(c + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int kc = min(KC, nk - c * KC);
    const float* b0 =
        bias_tile<DP>(smem_raw, c & 1) + (warp * 16 + gid) * BST;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nwin) break;
      const bf16* ks = kv_tile<DP>(smem_raw, c & 1, g, 0);
      if (kc == KC)
        stats_step<DP, false>(qf[g], ks, b0, b0 + 8 * BST, kc, scale, m[g],
                              l[g]);
      else
        stats_step<DP, true>(qf[g], ks, b0, b0 + 8 * BST, kc, scale, m[g],
                             l[g]);
    }
    __syncthreads();
  }

  // each row's exponent base and 1 / denominator, in place of m and l
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[g][i] = exp_base(m[g][i]);
      l[g][i] = 1.f / quad_sum(l[g][i]);
    }

  for (int c = 0; c < chunks; ++c) {
    const int t = chunks + c;
    if (c + 1 < chunks) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kc = min(KC, nk - c * KC);
    const float* b0 =
        bias_tile<DP>(smem_raw, t & 1) + (warp * 16 + gid) * BST;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nwin) break;
      const bf16* ks = kv_tile<DP>(smem_raw, t & 1, g, 0);
      const bf16* vs = kv_tile<DP>(smem_raw, t & 1, g, 1);
      if (kc == KC)
        normalised_step<DP, false>(qf[g], ks, vs, b0, b0 + 8 * BST, kc,
                                   scale, m[g], l[g], o[g]);
      else
        normalised_step<DP, true>(qf[g], ks, vs, b0, b0 + 8 * BST, kc, scale,
                                  m[g], l[g], o[g]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= nwin) break;
    store_out<DP>(rows, win[g], r0, r1, nq, d, o[g], 1.f, 1.f);
  }
}

}  // namespace mma
}  // namespace srk
