// The (S)W-MSA middle on a materialised qkv image: window cut, head split,
// attention with relative position bias and shift mask, head concat and
// window reverse, none of which touches device memory:
//
//   per ws x ws window of qkv (B, H, W, 3C), q = channels [0, C),
//   k = [C, 2C), v = [2C, 3C), heads as channel slices of d = C / heads:
//     o_h = softmax(q_h k_h^T * scale + bias_h + mask_w) v_h
//   bias (heads, N, N) float32; mask (nW, N, N) float32 indexed by the
//   window's position in its image, or (1, N, N) for every window, or none
//   out (B, H, W, C) in image layout, before the output projection.
//
// Replaces the TPU kernel fused_msa_attention of
// super_resolution_tpu/ops/pallas_attention.py (pallas_call at :444, body
// _msa_kernel :374-400). The image is the already rolled one for a shifted
// layer, as there: ATD's AC-MSA reads the same qkv image unrolled, so the
// roll stays with the caller. The tensor-core kernel also takes the shift
// itself, for fused_msa_block_shifted's middle (msa_block.cu): a projection
// works pixel by pixel, so that block projects the unrolled image, and
// token i of a rolled window reads q, k and v ss rows and columns on,
// cyclically, and writes its output at its own pixel, in rolled space.
//
// What bounds it on the H100: at ATD's chunk (four 160 x 160 tiles, 400
// windows of N 256, 6 heads of d 35) the two products are 4 * 256 * 256 *
// 35 = 9.2 MFLOP a (window, head): 22 GFLOP (0.022 ms on the tensor cores)
// against 0.17 GB of bf16 image plus 1.6 MB of bias and 26 MB of mask
// (0.060 ms at the HBM rate) and 157 M exponentials (0.040 ms on the
// special-function units). Bound by bytes; the bias and mask tiles every
// block reads through the L2 outweigh them.
//
// In bf16 it is mma_msa_attention_kernel, on the tensor-core tile of
// mma_attention.cuh (mma.sync.m16n8k16, bf16 operands, float32 sums,
// online softmax over chunks of kKeyChunk keys, two stages of cp.async in
// flight), with a block of its own: a block per (window, 64 query rows,
// head), windows fastest. Its rows come from the one qkv image: q, k and v
// at channel offsets 0, C and 2C of a 3C pixel row, head h at h * d, the
// pixel of token i found by a multiply-high (ws_magic), not a division.
// ATD's head slices are 70 bytes, so an odd head starts 2 bytes past a
// 4-byte boundary: no 16-byte and no plain 4-byte copies. The block copies
// the 4-byte words that cover the slice from the boundary below it, so
// column t of the shared row holds value t - s of the head (s = (h * d) &
// 1, the same for every row, since C is even). q is laid out with the same
// shift, so the q k^T sums are those of the head; column s - 1 of k and v
// (the neighbour's last value, which q's zero would not cancel were it
// infinite) is zeroed by the thread that copied it, once its copy has
// landed, and the columns of the output past the head are not stored. A
// word's half past the head is zero-filled by the copy (a 2-byte source).
// d pads to 16, 32 or 48 with room for the shift (d 35 -> 48; ATD-light's
// 12 -> 16, whose 24-byte slices are 4-byte aligned). Where C is odd or the
// image is not 4-byte aligned the copies are plain loads.
//
// The shift mask: each window has its own. A masked block stages the
// window's mask tile beside the bias tile, and a warp adds its 16 rows of
// the bias tile into the mask tile before it reads them, so the scores see
// one float32 term, bias + mask. A block of two windows sharing each bias
// tile, as the other tensor-core kernels take, was as fast without a mask
// and 1.5 times slower with one at ATD's shape on an H100 (PERF.md
// section 6), so a block takes one window.
//
// The cast points are the online softmax's: p = exp(s - m) is rounded to
// bf16 unnormalised and the output divided by the float32 denominator,
// where the TPU kernel normalises p before its cast (:391-395); one
// exponential a score, where the exact softmax takes two.
//
// In float32 it is the FMA kernel below, the exact check of the algorithm
// on the card; its entry refuses bf16. Design: one block per (window,
// head, 64 query rows), the layout of fused_attention (window_attention.cu)
// with the window's rows read straight from the image by index, as
// large_window_attention.cu reads them. The head's k and v (N x d each) go
// to shared memory once as float32 with d padded to 16, 32 or 48; the
// block then walks its query rows in tiles of 16, each a 16 x N float32
// score tile in shared memory (attention_tiles.cuh). At N 256, d 35: 96 kB
// of k and v, 16 kB of scores, 27 kB of q tile and reduction space, 143 kB
// a block. Windows are fastest in the grid, then query blocks, heads
// slowest: blocks that run together share one head's bias rows in the L2.
#include <stdint.h>

#include "attention_tiles.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kQT = 16;       // query rows of a score tile
constexpr int kQBlock = 64;   // query rows a block owns

size_t smem_bytes(int n, int dp) {
  return sizeof(float) * (2 * srk::round_up4(n) * dp +
                          kQT * srk::score_stride(n) + kQT * dp +
                          srk::kTileWarps * kQT * dp);
}

int pad_of(int d) { return (d + 15) / 16 * 16; }

template <int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    msa_attention_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int n_mask,
                         float* __restrict__ out, int windows, int H,
                         int W, int C, int heads, int ws, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = ws * ws;
  const int n4 = srk::round_up4(n);
  const int d = C / heads;
  const int h = blockIdx.y;
  const int widx = blockIdx.x % windows;
  const int qb = blockIdx.x / windows;
  const srk::Window win = srk::window_of(widx, H, W, ws);

  float* ks = smem;                               // n4 x DP
  float* vs = ks + n4 * DP;                       // n4 x DP
  float* sc = vs + n4 * DP;                       // kQT x stride(n)
  float* qs = sc + kQT * srk::score_stride(n);    // kQT x DP
  float* red = qs + kQT * DP;                     // warps x kQT x DP

  auto channel = [&](int tok, int part) {
    return qkv + win.pixel(tok) * 3 * C + part * C + h * d;
  };
  srk::load_rows_any<float, DP>(ks, n, n4, d,
                                [&](int j) { return channel(j, 1); });
  srk::load_rows_any<float, DP>(vs, n, n4, d,
                                [&](int j) { return channel(j, 2); });
  const float* bh = bias + static_cast<long long>(h) * n * n;
  // the mask of this window: by its position in its image, whatever order
  // the grid walks the windows in
  const int nw_img = (H / ws) * (W / ws);
  const float* mw =
      mask == nullptr
          ? nullptr
          : mask + static_cast<long long>(n_mask == 1 ? 0 : widx % nw_img) *
                       n * n;
  const int q_hi = min(n, (qb + 1) * kQBlock);
  for (int q0 = qb * kQBlock; q0 < q_hi; q0 += kQT) {
    const int qt = min(kQT, q_hi - q0);
    srk::load_rows_any<float, DP>(qs, qt, kQT, d,
                                  [&](int i) { return channel(q0 + i, 0); });
    __syncthreads();  // also covers the k and v loads before the first tile
    srk::attend_tile<float, DP, kQT>(
        qs, qt, ks, vs, n, sc, red, d, scale,
        [&](int i, int j) {
          const long long at = static_cast<long long>(q0 + i) * n + j;
          return mw == nullptr ? bh[at] : bh[at] + mw[at];
        },
        [&](int i, int t, float o) {
          out[win.pixel(q0 + i) * C + h * d + t] = o;
        });
  }
}

template <int DP>
cudaError_t launch(const float* qkv, const float* bias, const float* mask,
                   int n_mask, float* out, int B, int H, int W, int C,
                   int heads, int ws, float scale, cudaStream_t stream) {
  const int n = ws * ws;
  const int windows = B * (H / ws) * (W / ws);
  const size_t smem = smem_bytes(n, DP);
  cudaError_t err = srk::set_smem(msa_attention_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(windows * ((n + kQBlock - 1) / kQBlock), heads);
  msa_attention_kernel<DP><<<grid, srk::kTileThreads, smem, stream>>>(
      qkv, bias, mask, n_mask, out, windows, H, W, C, heads, ws, scale);
  return cudaGetLastError();
}

cudaError_t launch_padded(int dp, const float* qkv, const float* bias,
                          const float* mask, int n_mask, float* out, int B,
                          int H, int W, int C, int heads, int ws, float scale,
                          cudaStream_t stream) {
  switch (dp) {
    case 16:
      return launch<16>(qkv, bias, mask, n_mask, out, B, H, W, C, heads, ws,
                        scale, stream);
    case 32:
      return launch<32>(qkv, bias, mask, n_mask, out, B, H, W, C, heads, ws,
                        scale, stream);
    case 48:
      return launch<48>(qkv, bias, mask, n_mask, out, B, H, W, C, heads, ws,
                        scale, stream);
  }
  return cudaErrorInvalidValue;
}

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;
constexpr int kKC = mma::kKeyChunk, kBST = kKC + mma::kBiasPad;

// One stage: the bias tile, the window's mask tile where it has one, its k
// and v tiles.
__host__ __device__ constexpr int stage_bytes(int dp, bool masked) {
  return 4 * mma::kQRows * kBST * (masked ? 2 : 1) +
         2 * 2 * kKC * (dp + mma::kKvPad);
}

__host__ __device__ constexpr int mma_smem_bytes(int dp, bool masked) {
  return 2 * stage_bytes(dp, masked);
}

struct MsaArgs {
  const bf16* qkv;
  const float* bias;
  const float* mask;
  bf16* out;
  int n_mask, H, W, C, heads, ws, d;
  int ss;             // the shift at which q, k and v are read, or 0
  unsigned ws_magic;  // floor((2^32 - 1) / ws) + 1: i / ws = umulhi(i, it)
  float scale;
  bool words;     // C even, qkv 4-byte aligned: 4-byte words with the shift
  bool vec_bias;  // N % 4 == 0, bias and mask 16-byte aligned
};

// 4 bytes global -> shared, of which the first `bytes` (0, 2 or 4) are read
// and the rest zero-filled.
__device__ __forceinline__ void cp_async4_part(void* dst, const void* src,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// The block: grid (windows, ceil(N / 64), heads). SHIFTED: token i of a
// window reads q, k and v at its pixel moved by ss rows and columns,
// cyclically, and writes its output at its own pixel.
template <int DP, bool MASKED, bool SHIFTED>
__global__ void __launch_bounds__(mma::kThreads)
    mma_msa_attention_kernel(MsaArgs a) {
  constexpr int KC = kKC, BST = kBST, KST = DP + mma::kKvPad;
  constexpr int WORDS = DP / 2;
  constexpr int SB = stage_bytes(DP, MASKED);
  static_assert(mma::kThreads == 2 * KC, "a thread a (key, part) for word 0");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = a.ws, n = ws * ws, d = a.d, C = a.C;
  const int widx = blockIdx.x;
  const int q0 = blockIdx.y * mma::kQRows;
  const int h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // value t of the head sits in column t + s of a shared row
  const int s = a.words ? (h * d) & 1 : 0;
  const int hd = h * d;
  const float* bias_h = a.bias + static_cast<long long>(h) * n * n;
  const long long first = srk::window_of(widx, a.H, a.W, ws).first;
  // the mask of this window: by its position in its image
  const int nw_img = (a.H / ws) * (a.W / ws);
  // the first row of its image and its window's corner, for the shift
  [[maybe_unused]] const long long img_row0 =
      static_cast<long long>(widx / nw_img) * a.H;
  [[maybe_unused]] const int wy0 = (widx % nw_img) / (a.W / ws) * ws;
  [[maybe_unused]] const int wx0 = (widx % nw_img) % (a.W / ws) * ws;
  const float* mask_w =
      MASKED ? a.mask + static_cast<long long>(a.n_mask == 1 ? 0
                                                             : widx % nw_img) *
                            n * n
             : nullptr;
  auto pixel = [&](int i) {
    const int ky = __umulhi(static_cast<unsigned>(i), a.ws_magic);
    return first + static_cast<long long>(ky) * a.W + (i - ky * ws);
  };
  // the pixel token i reads: its own, or with the shift the one ss rows
  // and columns on, cyclically (y + ss < 2H: a compare, no division)
  auto src_pixel = [&](int i) {
    if constexpr (!SHIFTED) {
      return pixel(i);
    } else {
      const int ky = __umulhi(static_cast<unsigned>(i), a.ws_magic);
      int y = wy0 + ky + a.ss, x = wx0 + (i - ky * ws) + a.ss;
      if (y >= a.H) y -= a.H;
      if (x >= a.W) x -= a.W;
      return (img_row0 + y) * a.W + x;
    }
  };
  // the first value of token i's part (0 q, 1 k, 2 v) of this head
  auto row = [&](int part, int i) {
    return a.qkv + src_pixel(i) * 3 * C + part * C + hd;
  };
  auto bias_tile = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * SB);
  };
  auto mask_tile = [&](int st) { return bias_tile(st) + mma::kQRows * BST; };
  auto kv_tile = [&](int st, int part) {  // part 0 k, 1 v
    return reinterpret_cast<bf16*>(smem_raw + st * SB +
                                   4 * mma::kQRows * BST * (MASKED ? 2 : 1)) +
           part * KC * KST;
  };

  // rows q0 .. q0 + 63, keys c0 .. c0 + 63 of an (N, N) float32 matrix,
  // zero past them
  auto load_f32 = [&](float* dst, const float* src, int c0) {
    if (a.vec_bias) {
      for (int e = tid; e < mma::kQRows * KC / 4; e += mma::kThreads) {
        const int r = e / (KC / 4), col = (e % (KC / 4)) * 4;
        const bool ok = q0 + r < n && c0 + col < n;
        mma::cp_async16(dst + r * BST + col,
                        ok ? src + static_cast<long long>(q0 + r) * n + c0 +
                                 col
                           : a.bias,
                        ok);
      }
    } else {
      for (int e = tid; e < mma::kQRows * KC; e += mma::kThreads) {
        const int r = e / KC, col = e % KC;
        dst[r * BST + col] =
            (q0 + r < n && c0 + col < n)
                ? src[static_cast<long long>(q0 + r) * n + c0 + col]
                : 0.f;
      }
    }
  };
  auto load_chunk = [&](int c, int st) {
    const int c0 = c * KC;
    load_f32(bias_tile(st), bias_h, c0);
    if (MASKED) load_f32(mask_tile(st), mask_w, c0);
    bf16* ks = kv_tile(st, 0);
    bf16* vs = kv_tile(st, 1);
    if (a.words) {
      // word 0 of each (key, part): one a thread; its low half is the
      // neighbour's value where s = 1 (zeroed once it has landed), its high
      // half past the head where d + s < 2
      {
        const int j = tid >> 1, part = tid & 1;
        const bool key = c0 + j < n;
        cp_async4_part((part ? vs : ks) + j * KST,
                       row(part + 1, key ? c0 + j : 0) - s,
                       key ? (d + s >= 2 ? 4 : 2) : 0);
      }
      // words 1 .. WORDS - 1: the same word of k and of v of a key
      for (int e = tid; e < KC * (WORDS - 1); e += mma::kThreads) {
        const int j = e / (WORDS - 1), t = 2 * (1 + e % (WORDS - 1));
        const bool key = c0 + j < n;
        const int bytes = !key || t >= d + s ? 0 : (t + 1 < d + s ? 4 : 2);
        const bf16* src = row(1, key ? c0 + j : 0) - s + t;
        cp_async4_part(ks + j * KST + t, src, bytes);
        cp_async4_part(vs + j * KST + t, src + C, bytes);
      }
    } else {
      for (int e = tid; e < KC * DP; e += mma::kThreads) {
        const int j = e / DP, t = e % DP;
        const bool ok = c0 + j < n && t < d;
        const bf16* src = ok ? row(1, c0 + j) + t : nullptr;
        ks[j * KST + t] = ok ? src[0] : __float2bfloat16(0.f);
        vs[j * KST + t] = ok ? src[C] : __float2bfloat16(0.f);
      }
    }
  };

  // q of the warp's rows as A fragments, with the shift of k: column c
  // holds value c - s, zero outside the head and past N
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;
  uint32_t qf[DP / 16][4];
  float o[DP / 8][4];
  float m[2], l[2];
  {
    const bf16* qa = r0 < n ? row(0, r0) : nullptr;
    const bf16* qb = r1 < n ? row(0, r1) : nullptr;
    auto at = [&](const bf16* rw, int c) {
      const int t = c - s;
      return (rw != nullptr && t >= 0 && t < d) ? rw[t]
                                                : __float2bfloat16(0.f);
    };
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      const int c = kt * 16 + 2 * tig;
      qf[kt][0] = mma::pack(at(qa, c), at(qa, c + 1));
      qf[kt][1] = mma::pack(at(qb, c), at(qb, c + 1));
      qf[kt][2] = mma::pack(at(qa, c + 8), at(qa, c + 9));
      qf[kt][3] = mma::pack(at(qb, c + 8), at(qb, c + 9));
    }
    mma::clear_rows<DP>(o, m, l);
  }

  const int chunks = (n + KC - 1) / KC;
  load_chunk(0, 0);
  mma::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    // the stage of chunk c + 1 was last read in chunk c - 1, which ended
    // with a block barrier
    if (c + 1 < chunks) {
      load_chunk(c + 1, (c + 1) & 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    const int st = c & 1;
    // this thread's word 0 of chunk c has landed: zero the neighbour's value
    // in column 0 of its k or v row
    if (s) kv_tile(st, tid & 1)[(tid >> 1) * KST] = __float2bfloat16(0.f);
    __syncthreads();
    const int kc = min(KC, n - c * KC);
    const float* b0 =
        (MASKED ? mask_tile(st) : bias_tile(st)) + (warp * 16 + gid) * BST;
    if (MASKED) {
      // mask += bias over the warp's own 16 rows, which no other warp reads
      float4* mw = reinterpret_cast<float4*>(mask_tile(st) + warp * 16 * BST);
      const float4* bw =
          reinterpret_cast<const float4*>(bias_tile(st) + warp * 16 * BST);
      static_assert(16 * KC / 4 % 32 == 0, "whole float4s a lane");
#pragma unroll
      for (int i = 0; i < 16 * KC / 4 / 32; ++i) {
        const int e = i * 32 + lane;
        const int at = (e / (KC / 4)) * (BST / 4) + e % (KC / 4);
        const float4 mv = mw[at], bv = bw[at];
        mw[at] = make_float4(mv.x + bv.x, mv.y + bv.y, mv.z + bv.z,
                             mv.w + bv.w);
      }
      __syncwarp();
    }
    if (kc == KC)
      mma::chunk_step<DP, false>(qf, kv_tile(st, 0), kv_tile(st, 1), b0,
                                 b0 + 8 * BST, kc, a.scale, o, m, l);
    else
      mma::chunk_step<DP, true>(qf, kv_tile(st, 0), kv_tile(st, 1), b0,
                                b0 + 8 * BST, kc, a.scale, o, m, l);
    __syncthreads();
  }

  // column c of o is value c - s of the head's output
  const float l0 = mma::quad_sum(l[0]), l1 = mma::quad_sum(l[1]);
  bf16* oa = r0 < n ? a.out + pixel(r0) * C + hd : nullptr;
  bf16* ob = r1 < n ? a.out + pixel(r1) * C + hd : nullptr;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = j * 8 + 2 * tig + e - s;
      if (t < 0 || t >= d) continue;
      if (oa != nullptr) oa[t] = __float2bfloat16(o[j][e] / l0);
      if (ob != nullptr) ob[t] = __float2bfloat16(o[j][2 + e] / l1);
    }
  }
}

template <int DP, bool MASKED, bool SHIFTED>
cudaError_t launch_mma(const MsaArgs& a, int windows, cudaStream_t stream) {
  const int smem = mma_smem_bytes(DP, MASKED);
  cudaError_t err = srk::set_smem(
      mma_msa_attention_kernel<DP, MASKED, SHIFTED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(windows, (a.ws * a.ws + mma::kQRows - 1) / mma::kQRows,
                  a.heads);
  mma_msa_attention_kernel<DP, MASKED, SHIFTED>
      <<<grid, mma::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The entry lets a shift through only with its mask and a head dim of at
// most 32 (fused_msa_block's), so DP 48 has no shifted instance.
template <int DP>
cudaError_t launch_mma_padded(const MsaArgs& a, int windows,
                              cudaStream_t stream) {
  if constexpr (DP <= 32) {
    if (a.ss) return launch_mma<DP, true, true>(a, windows, stream);
  }
  return a.mask ? launch_mma<DP, true, false>(a, windows, stream)
                : launch_mma<DP, false, false>(a, windows, stream);
}

}  // namespace tc

// The window layout both kernels take: head dims up to 48, whole windows,
// a mask for every window or for each window of one image.
bool bad_shape(int B, int H, int W, int C, int heads, int ws,
               const float* mask, int n_mask) {
  if (heads < 1 || heads > 65535 || C % heads || ws < 1 || H % ws ||
      W % ws || B < 1 || C / heads > 48)
    return true;
  return mask != nullptr && n_mask != 1 && n_mask != (H / ws) * (W / ws);
}

}  // namespace

// Bytes of dynamic shared memory a block needs for window ws and head dim
// d; the wrapper holds this against the card's limit.
extern "C" int sr_msa_attention_smem(int ws, int d) {
  return static_cast<int>(smem_bytes(ws * ws, pad_of(d)));
}

// The FMA kernel. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_msa_attention's. qkv (B, H, W, 3C), out (B, H, W, C), bias
// (heads, ws^2, ws^2) float32, mask (n_mask, ws^2, ws^2) float32 with
// n_mask 1 or the windows of one image, or null for no mask. Head dims up
// to 48. Returns the cudaError_t of the launch.
extern "C" int sr_msa_attention(int dtype, const void* qkv, const void* bias,
                                const void* mask, int n_mask, void* out,
                                int B, int H, int W, int C, int heads, int ws,
                                float scale, void* stream) {
  const float* mf = static_cast<const float*>(mask);
  if (dtype != 0 || bad_shape(B, H, W, C, heads, ws, mf, n_mask))
    return cudaErrorInvalidValue;
  return launch_padded(pad_of(C / heads), static_cast<const float*>(qkv),
                       static_cast<const float*>(bias), mf, n_mask,
                       static_cast<float*>(out), B, H, W, C, heads, ws, scale,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a block of the tensor-core kernel needs at
// head dim d, with or without a mask, whatever the window.
extern "C" int sr_mma_msa_attention_smem(int d, int masked) {
  return tc::mma_smem_bytes(pad_of(d), masked != 0);
}

// fused_msa_attention in bf16 on the tensor cores: operands as
// sr_msa_attention's, qkv and out bf16; the shared memory is
// sr_mma_msa_attention_smem's. ss: 0, or the shift 0 < ss < ws at which
// token i of a window reads q, k and v (at its pixel ss rows and columns
// on, cyclically), its output still written at its own pixel: the middle of
// fused_msa_block_shifted (msa_block.cu), which passes its mask and a head
// dim of at most 32. Returns the cudaError_t of the launch.
extern "C" int sr_mma_msa_attention(const void* qkv, const void* bias,
                                    const void* mask, int n_mask, void* out,
                                    int B, int H, int W, int C, int heads,
                                    int ws, int ss, float scale,
                                    void* stream) {
  const float* mf = static_cast<const float*>(mask);
  // ws_magic finds a token's row exactly for tokens below ws^2 while ws^3 <
  // 2^32
  if (bad_shape(B, H, W, C, heads, ws, mf, n_mask) || ws > 1024 ||
      ss < 0 || ss >= ws || (ss && (mf == nullptr || C / heads > 32)))
    return cudaErrorInvalidValue;
  tc::MsaArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.bias = static_cast<const float*>(bias);
  a.mask = mf;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n_mask = n_mask;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.ws = ws;
  a.d = C / heads;
  a.ss = ss;
  a.ws_magic = 0xffffffffu / static_cast<unsigned>(ws) + 1u;
  a.scale = scale;
  // a pixel row is 3C values: even for C even, so every head's slice lies
  // a whole number of 4-byte words, or that and one value, past a boundary
  a.words = C % 2 == 0 && (reinterpret_cast<uintptr_t>(qkv) & 3u) == 0;
  a.vec_bias = (ws * ws) % 4 == 0 && srk::mma::aligned16(bias) &&
               (mf == nullptr || srk::mma::aligned16(mf));
  const int windows = B * (H / ws) * (W / ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pad_of(a.d)) {
    case 16:
      return tc::launch_mma_padded<16>(a, windows, st);
    case 32:
      return tc::launch_mma_padded<32>(a, windows, st);
    case 48:
      return tc::launch_mma_padded<48>(a, windows, st);
  }
  return cudaErrorInvalidValue;
}
