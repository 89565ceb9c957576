// HiT-SRF's spatial-channel correlation (SCC) after the qv projection, NHWC,
// with its base projection and output projection:
//
//   per wh x ww window of the [q | v] image (L tokens, c2 = C / 2 each half):
//     vs     = P v + sl_b          (baseL x c2: each bh x bw base cell sums
//                                   its sub-grid through spatial_linear)
//     corr_h = q_h vs_h^T / d + bias_h        per head, NO softmax
//     xs     = concat_h(corr_h vs_h)          (L x c2)
//     corr_c = q^T v / L                      (c2 x c2, one head)
//     xc     = v corr_c^T                     (L x c2)
//     out    = [xs | xc] Wproj + bproj
//
// Replaces the TPU kernel of super_resolution_tpu/ops/pallas_attention.py:
// fused_scc_block (pallas_call at :1539, body _scc_block_kernel). The casts
// are the TPU kernel's: vs, corr, xs, xc and corr_c are formed in float32
// and rounded to T once; the output projection accumulates in float32.
//
// What bounds it on the H100: at HiT-SRF's width (C 60, 6 heads of 5, base
// 8 x 8) a token costs about 8.3 k multiply-adds against 240 bytes of bf16
// image traffic, 70 FLOP/byte: far under either ridge, so the bound is the
// bytes (the image in and out, the bias once); the bias, read once a
// (window, head, token), is the real traffic, through the L2.
//
// In bf16 it is the tensor-core kernels of namespace tc (mma.sync.m16n8k16,
// bf16 operands, float32 sums), at the same cast points. Head dim 5 is no
// reason to stay off the tensor cores: each half (q, v) is padded to C2P =
// 32 (or 64) channels, and a head's products take the whole padded half
// with the other heads' channels masked to zero in the B fragments, a 3.2x
// waste of products that run at about 15x the float32 FMA rate. A warp
// takes 16 token rows of one window, q and v as A fragments:
//   corr_h  q vs^T per 16 base cells: vs as B (ldmatrix of its rows), the
//           channels outside head h zeroed; scaled by 1 / d, the bias added
//           in float32 and rounded straight into the A fragment of
//   xs_h    corr_h vs: vs as B (ldmatrix.trans), its columns outside head h
//           zeroed, into c2-wide accumulators that every head adds its own
//           channels to: xs is the head concat without a copy;
//   xc      v corr_c^T, corr_c's rows as B;
//   out     [round(xs) | round(xc)] W_proj + b_proj: the accumulators are
//           the A fragments, W_proj's rows regrouped to xs's C2P rows and
//           xc's C2P rows.
// A block of 8 warps takes 128 token rows: whole windows of at most 128
// tokens (the 4 x 4 window, 8 a block; 8 x 8, 2 a block), which it reduces
// itself (vs by float32 FMA sums, a window's Gram q^T v by one warp on the
// tensor cores), or 128 rows of a larger window, whose vs and partial Grams
// the reduction pass (mma_scc_reduce_kernel, one block a (window, slice))
// leaves in the scratch: vs as float32 sums, the Gram on the tensor cores,
// the warps' sums in warp order, the slices' in slice order.
//
// In float32 it is the FMA kernels below, the first version and the exact
// check on the card; their entry refuses bf16. Halves of 30 channels take
// no 16-byte load of the image there, and every product is a float32 FMA
// loop; what it waits for is the instruction rate of those loops and the
// latency of shared memory, so the design keeps many warps on an SM.
//
// Design. The TPU kernel is one program per window because VMEM forces it.
// Here only two things need all L tokens of a window: vs and corr_c, both
// small reductions. After them every token row is independent. So a wrapper
// call is two launches:
//   1. scc_reduce_kernel, one block per (window, slice of base-cell rows):
//      vs of the slice's base cells (complete) and the slice's partial Gram,
//      both float32, into scratch the wrapper allocates. The main kernel
//      adds the partial Grams in slice order, so the sum has one order.
//   2. scc_block_kernel, one block per (window, kRows token rows): stages
//      its rows of q and v, the window's vs and corr_c and Wproj in shared
//      memory. One thread per (row, head) then walks the base cells with q_h
//      and the head's slice of xs in registers: a correlation is formed,
//      rounded and spent at once, so the (rows x baseL) correlations of a
//      head never exist as a tile and a block needs 47 kB, four blocks an SM.
//      The lanes of a warp are 32 rows of one head: a cell's vs is one
//      broadcast read, and a lane reads its own row of the bias 16 bytes at
//      a time. Then xc, then the projection.
// A window of at most kRows tokens (the 4 x 4 window of ratio 0.5: 9,216
// windows of 16 tokens a chunk) is reduced by the main kernel itself from
// the rows it staged, kRows / L windows a block, and launch 1 is skipped.
// The grid of launch 2 puts the windows fastest, so blocks that run
// together read the same rows of the bias ((heads, L, baseL) float32, 6.3 MB
// at window 64, the same for every window) and the L2 serves all but the
// first read. P is never formed: a token's weight is sl_w at its
// sub-position inside its base cell. vs is kept split by head, each head's
// d values padded to DP = 8, 16 or 32 floats, in the scratch as in shared
// memory.
#include <stdint.h>

#include "common.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;        // token rows of a block of the main kernel
constexpr int kChunk = 64;       // tokens a reduce block stages at a time
constexpr int kSplitTokens = 256;  // least tokens of a reduce block's slice
constexpr int kMaxGram = 16;     // Gram entries a reduce thread keeps
constexpr int kMaxHalf = 64;     // c2 * c2 <= kMaxGram * kThreads
constexpr int kMaxD = 32;        // largest head dim

struct Geom {
  int H, W, wh, ww, bh, bw, nwy, nwx;
};

// Pixel index (b * H + y) * W + x of token l of window win.
__device__ __forceinline__ int pixel_of(const Geom& g, int win, int l) {
  const int per_img = g.nwy * g.nwx;
  const int b = win / per_img, wi = win % per_img;
  const int y = (wi / g.nwx) * g.wh + l / g.ww;
  const int x = (wi % g.nwx) * g.ww + l % g.ww;
  return (b * g.H + y) * g.W + x;
}

using srk::DivMod;

// First token of base cell m: its sub-position (a, b) is token + a * ww + b.
__device__ __forceinline__ int cell_token(const Geom& g, int m) {
  return (m / g.bw) * (g.wh / g.bh) * g.ww + (m % g.bw) * (g.ww / g.bw);
}

// Floats a head's slice of a vs row takes: d padded to 8, 16 or 32.
__host__ __device__ inline int head_pad(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scc_reduce_kernel(const T* __restrict__ qv, const T* __restrict__ slw,
                      const T* __restrict__ slb, float* __restrict__ vs_scr,
                      float* __restrict__ gram_scr, Geom g, int c, int heads,
                      int nsplit) {
  extern __shared__ float smem[];
  float* rows = smem;                                      // kChunk x c
  int* pix = reinterpret_cast<int*>(rows + kChunk * c);    // kChunk
  int* cell_pix = pix + kChunk;            // first pixel of the slice's cells
  const int c2 = c / 2, d = c2 / heads, dp = head_pad(d), bl = g.bh * g.bw;
  const int sh = g.wh / g.bh, sw = g.ww / g.bw;
  const int win = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int cells = (g.bh / nsplit) * g.bw;  // whole rows of base cells
  const int m_lo = split * cells;
  const int l_lo = split * (g.bh / nsplit) * sh * g.ww;
  const int l_n = (g.bh / nsplit) * sh * g.ww;  // its tokens, contiguous

  for (int m = threadIdx.x; m < cells; m += blockDim.x)
    cell_pix[m] = pixel_of(g, win, cell_token(g, m_lo + m));
  __syncthreads();
  const float b0 = srk::to_f(slb[0]);
  DivMod o(threadIdx.x, blockDim.x, heads * dp);   // (cell, padded channel)
  for (; o.q < cells; o.next()) {
    const int h = o.r / dp, t = o.r % dp;          // dp is a power of two
    float val = 0.f;
    if (t < d) {
      const T* vp = qv + static_cast<long long>(cell_pix[o.q]) * c + c2 +
                    h * d + t;
      float acc = 0.f;
      for (int a = 0; a < sh; ++a)
        for (int b = 0; b < sw; ++b)
          acc = fmaf(srk::to_f(slw[a * sw + b]),
                     srk::to_f(vp[static_cast<long long>(a * g.W + b) * c]),
                     acc);
      val = srk::round_to<T>(acc + b0);
    }
    vs_scr[(static_cast<long long>(win) * bl + m_lo + o.q) * heads * dp +
           o.r] = val;
  }

  float acc[kMaxGram];
#pragma unroll
  for (int k = 0; k < kMaxGram; ++k) acc[k] = 0.f;
  const DivMod gram0(threadIdx.x, kThreads, c2);  // (q channel, v channel)
  for (int l0 = 0; l0 < l_n; l0 += kChunk) {
    const int n = min(kChunk, l_n - l0);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x)
      pix[r] = pixel_of(g, win, l_lo + l0 + r);
    __syncthreads();
    DivMod e(threadIdx.x, blockDim.x, c);  // (row, channel)
    for (; e.q < n; e.next())
      rows[e.q * c + e.r] =
          srk::to_f(qv[static_cast<long long>(pix[e.q]) * c + e.r]);
    __syncthreads();
    DivMod go = gram0;
#pragma unroll
    for (int k = 0; k < kMaxGram; ++k, go.next()) {
      if (go.q < c2) {
        const float* qc = rows + go.q;
        const float* vd = rows + c2 + go.r;
        float a = acc[k];
        for (int r = 0; r < n; ++r) a = fmaf(qc[r * c], vd[r * c], a);
        acc[k] = a;
      }
    }
  }
  float* gp = gram_scr +
              (static_cast<long long>(win) * nsplit + split) * c2 * c2;
#pragma unroll
  for (int k = 0; k < kMaxGram; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < c2 * c2) gp[e] = acc[k];
  }
}

// One base cell for one (row, head): the correlation of q with the cell's
// vs, scaled, biased and rounded to T, then spent on the row's xs. vrow:
// the head's DP floats of the cell's vs, 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void correlate_cell(const float* vrow, float bias_m,
                                               const float (&q)[D],
                                               float (&acc)[D], int d,
                                               float inv_d) {
  constexpr int DP = (D + 3) / 4 * 4;
  float v[DP];
#pragma unroll
  for (int j = 0; j < DP; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(vrow + j);
    v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
  }
  float dot = 0.f;
#pragma unroll
  for (int t = 0; t < D; ++t)
    if (t < d) dot = fmaf(q[t], v[t], dot);
  const float corr = srk::round_to<T>(dot * inv_d + bias_m);
#pragma unroll
  for (int t = 0; t < D; ++t)
    if (t < d) acc[t] = fmaf(corr, v[t], acc[t]);
}

// Rows of a block: wpb windows of tr tokens each, window-major. nsplit 0:
// tr == L and the block reduces its windows itself. D: the head dim d, or
// the next of 8, 16, 32 above it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    scc_block_kernel(const T* __restrict__ qv, const T* __restrict__ slw,
                     const T* __restrict__ slb, const T* __restrict__ wproj,
                     const T* __restrict__ bproj,
                     const float* __restrict__ bias,
                     const float* __restrict__ vs_scr,
                     const float* __restrict__ gram_scr, T* __restrict__ out,
                     Geom g, int c, int heads, int n_win, int nsplit, int tr,
                     int wpb) {
  extern __shared__ float smem[];
  const int c2 = c / 2, d = c2 / heads, dp = head_pad(d);
  const int L = g.wh * g.ww, bl = g.bh * g.bw;
  const int sh = g.wh / g.bh, sw = g.ww / g.bw;
  const int cst = c2 | 1;        // odd row stride: no bank conflicts
  const int vstep = heads * dp;  // floats of a base cell's vs
  float* qvs = smem;                       // kRows x c: q | v of the rows
  float* xcat = qvs + kRows * c;           // kRows x c: xs | xc rounded to T
  float* wsm = xcat + kRows * c;           // c x c
  float* vs = wsm + c * c;                 // wpb x bl x heads x dp
  float* cc = vs + wpb * bl * vstep;       // wpb x c2 x cst
  int* pix = reinterpret_cast<int*>(cc + wpb * c2 * cst);  // kRows
  int* row_tok = pix + kRows;     // kRows: a row's token in its window
  int* row_win = row_tok + kRows; // kRows: its window among the block's
  int* cell_tok = row_win + kRows;  // bl: first token of each base cell

  const int win0 = blockIdx.x * wpb;
  const int l0 = blockIdx.y * tr;
  const int rows = wpb * tr;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int w = r / tr, l = l0 + r % tr;
    row_win[r] = w;
    row_tok[r] = l;
    pix[r] = (win0 + w < n_win && l < L) ? pixel_of(g, win0 + w, l) : -1;
  }
  for (int m = threadIdx.x; m < bl; m += blockDim.x)
    cell_tok[m] = cell_token(g, m);
  for (int e = threadIdx.x; e < c * c; e += blockDim.x)
    wsm[e] = srk::to_f(wproj[e]);
  __syncthreads();
  {
    DivMod e(threadIdx.x, blockDim.x, c);  // (row, channel)
    for (; e.q < rows; e.next()) {
      const int p = pix[e.q];
      qvs[e.q * c + e.r] =
          p < 0 ? 0.f : srk::to_f(qv[static_cast<long long>(p) * c + e.r]);
    }
  }
  const float inv_l = 1.f / static_cast<float>(L);
  if (nsplit == 0) {
    __syncthreads();
    const float b0 = srk::to_f(slb[0]);
    for (int w = 0; w < wpb; ++w) {
      const float* tile = qvs + w * tr * c;
      DivMod o(threadIdx.x, blockDim.x, vstep);   // (base cell, padded ch.)
      for (; o.q < bl; o.next()) {
        const int h = o.r / dp, t = o.r % dp;
        float val = 0.f;
        if (t < d) {
          const float* vp = tile + cell_tok[o.q] * c + c2 + h * d + t;
          float acc = 0.f;
          for (int a = 0; a < sh; ++a)
            for (int b = 0; b < sw; ++b)
              acc = fmaf(srk::to_f(slw[a * sw + b]), vp[(a * g.ww + b) * c],
                         acc);
          val = srk::round_to<T>(acc + b0);
        }
        vs[(w * bl + o.q) * vstep + o.r] = val;
      }
      DivMod e(threadIdx.x, blockDim.x, c2);   // (q channel, v channel)
      for (; e.q < c2; e.next()) {
        const float* qc = tile + e.q;
        const float* vd = tile + c2 + e.r;
        float acc = 0.f;
        for (int l = 0; l < L; ++l) acc = fmaf(qc[l * c], vd[l * c], acc);
        cc[(w * c2 + e.q) * cst + e.r] = srk::round_to<T>(acc * inv_l);
      }
    }
  } else {
    const float4* vp = reinterpret_cast<const float4*>(
        vs_scr + static_cast<long long>(win0) * bl * vstep);
    for (int e = threadIdx.x; e < bl * vstep / 4; e += blockDim.x)
      reinterpret_cast<float4*>(vs)[e] = vp[e];
    const float* gp =
        gram_scr + static_cast<long long>(win0) * nsplit * c2 * c2;
    DivMod e(threadIdx.x, blockDim.x, c2);
    for (; e.q < c2; e.next()) {
      float acc = 0.f;
      for (int s = 0; s < nsplit; ++s)
        acc += gp[(s * c2 + e.q) * c2 + e.r];
      cc[e.q * cst + e.r] = srk::round_to<T>(acc * inv_l);
    }
  }
  __syncthreads();

  // xs of one (row, head) a thread: corr[m] = q_h . vs_h[m] / d + bias[h][l][m]
  // rounded to T, xs_h += corr[m] vs_h[m], over the base cells m
  const float inv_d = 1.f / static_cast<float>(d);
  for (int item = threadIdx.x; item < heads * kRows; item += blockDim.x) {
    const int r = item % kRows, h = item / kRows;
    if (r >= rows || pix[r] < 0) continue;
    float q[D], acc[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      q[t] = t < d ? qvs[r * c + h * d + t] : 0.f;
      acc[t] = 0.f;
    }
    const float* vrow = vs + row_win[r] * bl * vstep + h * dp;
    const float* brow =
        bias + (static_cast<long long>(h) * L + row_tok[r]) * bl;
    if ((bl & 3) == 0) {
      float4 b4 = __ldg(reinterpret_cast<const float4*>(brow));
      for (int m = 0; m < bl; m += 4) {
        const float4 cur = b4;
        if (m + 4 < bl)   // ask for the next four ahead of this four's work
          b4 = __ldg(reinterpret_cast<const float4*>(brow + m + 4));
        const float* vr = vrow + m * vstep;
        correlate_cell<T, D>(vr, cur.x, q, acc, d, inv_d);
        correlate_cell<T, D>(vr + vstep, cur.y, q, acc, d, inv_d);
        correlate_cell<T, D>(vr + 2 * vstep, cur.z, q, acc, d, inv_d);
        correlate_cell<T, D>(vr + 3 * vstep, cur.w, q, acc, d, inv_d);
      }
    } else {
      for (int m = 0; m < bl; ++m)
        correlate_cell<T, D>(vrow + m * vstep, brow[m], q, acc, d, inv_d);
    }
#pragma unroll
    for (int t = 0; t < D; ++t)
      if (t < d) xcat[r * c + h * d + t] = srk::round_to<T>(acc[t]);
  }

  // xc[r][ch] = v[r] . corr_c[ch]
  {
    DivMod o(threadIdx.x, blockDim.x, c2);   // (row, channel of a half)
    for (; o.q < rows; o.next()) {
      if (pix[o.q] < 0) continue;
      const float* vr = qvs + o.q * c + c2;
      const float* cw = cc + (row_win[o.q] * c2 + o.r) * cst;
      float acc = 0.f;
      for (int t = 0; t < c2; ++t) acc = fmaf(vr[t], cw[t], acc);
      xcat[o.q * c + c2 + o.r] = srk::round_to<T>(acc);
    }
  }
  __syncthreads();

  srk::block_gemm<4, 2>(
      rows, c, c,
      [&](int m, int k) { return pix[m] < 0 ? 0.f : xcat[m * c + k]; },
      [&](int k, int n) { return wsm[k * c + n]; },
      [&](int m, int n, float acc) {
        if (pix[m] >= 0)
          out[static_cast<long long>(pix[m]) * c + n] =
              srk::from_f<T>(acc + srk::to_f(bproj[n]));
      });
}

// Windows a block of the main kernel takes: several only where two or more
// whole windows fit its rows.
int windows_per_block(int L) { return L <= kRows / 2 ? kRows / L : 1; }

size_t main_smem_bytes(int L, int bl, int c, int heads) {
  const int c2 = c / 2, wpb = windows_per_block(L);
  return sizeof(float) * (2 * kRows * c + c * c +
                          wpb * bl * heads * head_pad(c2 / heads) +
                          wpb * c2 * (c2 | 1)) +
         sizeof(int) * (3 * kRows + bl);
}

size_t reduce_smem_bytes(int bl, int c) {
  return sizeof(float) * kChunk * c + sizeof(int) * (kChunk + bl);
}

// Slices the reduction pass cuts a window into, by rows of base cells: the
// most that leave a slice at least kSplitTokens tokens. 0: the window fits
// the rows of one block of the main kernel, which reduces it itself.
int reduce_splits(int L, int bh) {
  if (L <= kRows) return 0;
  int splits = 1;
  for (int s = 2; s <= bh; ++s)
    if (bh % s == 0 && L / s >= kSplitTokens) splits = s;
  return splits;
}

// Floats of a window's vs, split by head. The scratch holds vs of every
// window, then a partial Gram a (window, slice).
size_t vs_floats(int bl, int c, int heads) {
  return static_cast<size_t>(bl) * heads * head_pad(c / 2 / heads);
}

bool shape_ok(int wh, int ww, int bh, int bw, int c, int heads) {
  return wh >= 1 && ww >= 1 && bh >= 1 && bw >= 1 && heads >= 1 &&
         wh % bh == 0 && ww % bw == 0 && c % 2 == 0 && c / 2 <= kMaxHalf &&
         (c / 2) % heads == 0 && c / 2 / heads <= kMaxD;
}

template <typename T, int D>
cudaError_t launch_main(const void* qv, const void* slw, const void* slb,
                        const void* wproj, const void* bproj,
                        const float* bias, const float* vs_scr,
                        const float* gram_scr, void* out, const Geom& g,
                        int c, int heads, int n_win, int nsplit,
                        cudaStream_t stream) {
  const int L = g.wh * g.ww;
  const int tr = L < kRows ? L : kRows, wpb = windows_per_block(L);
  const size_t smem = main_smem_bytes(L, g.bh * g.bw, c, heads);
  cudaError_t err = srk::set_smem(scc_block_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_win + wpb - 1) / wpb, (L + tr - 1) / tr);
  scc_block_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qv), static_cast<const T*>(slw),
      static_cast<const T*>(slb), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), bias, vs_scr, gram_scr,
      static_cast<T*>(out), g, c, heads, n_win, nsplit, tr, wpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qv, const void* slw, const void* slb,
                   const void* wproj, const void* bproj, const float* bias,
                   float* scratch, void* out, int B, int H, int W, int c,
                   int heads, int wh, int ww, int bh, int bw,
                   cudaStream_t stream) {
  if (!shape_ok(wh, ww, bh, bw, c, heads) || H % wh || W % ww)
    return cudaErrorInvalidValue;
  const int L = wh * ww, bl = bh * bw, d = c / 2 / heads;
  const int nsplit = reduce_splits(L, bh);
  const Geom g{H, W, wh, ww, bh, bw, H / wh, W / ww};
  const int n_win = B * g.nwy * g.nwx;
  float* vs_scr = scratch;
  float* gram_scr = scratch + n_win * vs_floats(bl, c, heads);
  if (nsplit) {
    const size_t rs = reduce_smem_bytes(bl, c);
    cudaError_t err = srk::set_smem(scc_reduce_kernel<T>, rs);
    if (err != cudaSuccess) return err;
    scc_reduce_kernel<T><<<n_win * nsplit, kThreads, rs, stream>>>(
        static_cast<const T*>(qv), static_cast<const T*>(slw),
        static_cast<const T*>(slb), vs_scr, gram_scr, g, c, heads, nsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // HiT-SRF's head dim of 5 gets loops of its own length; any other the
  // next of 8, 16, 32
  if (d == 5)
    return launch_main<T, 5>(qv, slw, slb, wproj, bproj, bias, vs_scr,
                             gram_scr, out, g, c, heads, n_win, nsplit,
                             stream);
  if (d <= 8)
    return launch_main<T, 8>(qv, slw, slb, wproj, bproj, bias, vs_scr,
                             gram_scr, out, g, c, heads, n_win, nsplit,
                             stream);
  if (d <= 16)
    return launch_main<T, 16>(qv, slw, slb, wproj, bproj, bias, vs_scr,
                              gram_scr, out, g, c, heads, n_win, nsplit,
                              stream);
  return launch_main<T, 32>(qv, slw, slb, wproj, bproj, bias, vs_scr,
                            gram_scr, out, g, c, heads, n_win, nsplit,
                            stream);
}

namespace tc {

namespace mma = srk::mma;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // token rows of a block, 16 a warp
constexpr int kPad = 8;             // bf16 after each row of a tile
// blocks an SM the main kernel is compiled for at C2P 32 (80 registers,
// 80 B spilled): 2, which its 121 registers allow, took 1.06-1.15x the
// time of 3 at HiT-SRF's six windows (tools/front_scc_variants.py)
constexpr int kMinBlocks = 3;

// A half (q or v) padded to 32 or 64 channels: C2P.
__host__ __device__ inline int half_width(int c2) {
  return c2 <= 32 ? 32 : 64;
}

// Warp tiles (16 rows) a window takes: a window of at most kRows tokens is
// ceil(L / 16) tiles of one block; a larger one fills whole blocks.
__host__ __device__ inline int tiles_per_window(int L) {
  return L <= kRows ? (L + 15) / 16 : kWarps;
}

__host__ __device__ inline int windows_per_block(int L) {
  return kWarps / tiles_per_window(L);
}

// Slices of the reduction pass: none where a block holds whole windows and
// reduces them itself, else by reduce_splits' rule.
inline int splits(int L, int bh) {
  return L <= kRows ? 0 : reduce_splits(L, bh);
}

// Base cells rounded up to a k16 step of xs.
__host__ __device__ inline int cells_padded(int bl) {
  return (bl + 15) / 16 * 16;
}

// Bytes of the main kernel's shared memory: the block's rows of [q | v]
// (each half padded to C2P), W_proj regrouped to 2 C2P rows, vs and the
// channel correlation of each of its windows, a pixel and a token a row.
inline int main_smem_bytes(int L, int bl, int c) {
  const int c2p = half_width(c / 2), qst = 2 * c2p + kPad, vst = c2p + kPad;
  const int wpb = windows_per_block(L);
  return 2 * (kRows * qst + 2 * c2p * qst + wpb * cells_padded(bl) * vst +
              wpb * c2p * vst) +
         8 * kRows;
}

// Bytes of the reduction pass's: a chunk of rows of [q | v], the Gram of
// the slice in float32 and a pixel a row.
inline int reduce_smem_bytes(int c) {
  const int c2p = half_width(c / 2);
  return 2 * kRows * (2 * c2p + kPad) + 4 * c2p * c2p + 4 * kRows;
}

struct SccArgs {
  const bf16* qv;  // (B, H, W, c): [q | v]
  const bf16* slw;
  const bf16* slb;
  const bf16* wproj;  // (c, c)
  const bf16* bproj;
  const float* bias;  // (heads, L, bl)
  float* vs_scr;      // (windows, bl, c2), rounded to bf16
  float* gram_scr;    // (windows, slices, C2P, C2P)
  bf16* out;
  Geom g;
  int c, heads, n_win, nsplit;
  bool vec_bias;  // float2 reads of the bias (bl even, 8-byte aligned)
  bool pairs;     // out written as bf16 pairs (4-byte aligned)
  bool qv_pairs;  // the qv rows and W_proj read as bf16 pairs (c2 even)
};

// The rows of [q | v] of pixel pix[r] into the tile (each half zero past
// c2 to C2P; a row whose pixel is -1 zero).
template <int C2P>
__device__ __forceinline__ void stage_rows(bf16* rows, const int* pix,
                                           const SccArgs& a) {
  constexpr int QST = 2 * C2P + kPad;
  const int c = a.c, c2 = c / 2;
  const bf16 zero = __float2bfloat16(0.f);
  if (a.qv_pairs) {
    for (int e = threadIdx.x; e < kRows * C2P; e += kBlockThreads) {
      const int r = e / C2P, col = 2 * (e % C2P);
      const int hf = col / C2P, ch = col % C2P;
      const int p = pix[r];
      *reinterpret_cast<uint32_t*>(rows + r * QST + col) =
          p >= 0 && ch < c2
              ? *reinterpret_cast<const uint32_t*>(
                    a.qv + static_cast<long long>(p) * c + hf * c2 + ch)
              : 0u;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * 2 * C2P; e += kBlockThreads) {
      const int r = e / (2 * C2P), col = e % (2 * C2P);
      const int hf = col / C2P, ch = col % C2P;
      const int p = pix[r];
      rows[r * QST + col] =
          p >= 0 && ch < c2
              ? a.qv[static_cast<long long>(p) * c + hf * c2 + ch]
              : zero;
    }
  }
}

// G += q^T v over `steps` 16-row steps of a tile of [q | v] rows, by one
// warp: A = q^T (rows the q channels, k the tokens) and B = v (k the
// tokens, n the v channels), both through ldmatrix.trans of the rows.
template <int C2P>
__device__ __forceinline__ void gram_steps(const bf16* rows, int steps,
                                           float (&g)[C2P / 16][C2P / 8][4]) {
  constexpr int QST = 2 * C2P + kPad;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  for (int s = 0; s < steps; ++s) {
    const bf16* t = rows + s * 16 * QST;
    uint32_t af[C2P / 16][4], bw[C2P / 16][4];
#pragma unroll
    for (int i = 0; i < C2P / 16; ++i) {
      mma::ldsm_x4_trans(af[i], t + (8 * (mi >> 1) + r8) * QST + 16 * i +
                                    8 * (mi & 1));
      mma::ldsm_x4_trans(bw[i], t + (8 * (mi & 1) + r8) * QST + C2P +
                                    16 * i + 8 * (mi >> 1));
    }
#pragma unroll
    for (int i = 0; i < C2P / 16; ++i)
#pragma unroll
      for (int np = 0; np < C2P / 16; ++np) {
        mma::mma_bf16(g[i][2 * np], af[i], bw[np][0], bw[np][1]);
        mma::mma_bf16(g[i][2 * np + 1], af[i], bw[np][2], bw[np][3]);
      }
  }
}

// One block per (window, slice of base-cell rows) of a window of more than
// kRows tokens: vs of the slice's cells (float32 sums, rounded to bf16) and
// the slice's partial Gram q^T v on the tensor cores, each warp 16 rows of
// every chunk of kRows tokens, the warps' sums added in warp order.
template <int C2P>
__global__ void __launch_bounds__(kBlockThreads)
    mma_scc_reduce_kernel(SccArgs a) {
  constexpr int QST = 2 * C2P + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rows = reinterpret_cast<bf16*>(smem_raw);                // kRows x QST
  float* gsum = reinterpret_cast<float*>(rows + kRows * QST);    // C2P x C2P
  int* pix = reinterpret_cast<int*>(gsum + C2P * C2P);           // kRows
  const Geom& g = a.g;
  const int c = a.c, c2 = c / 2, bl = g.bh * g.bw, ns = a.nsplit;
  const int sh = g.wh / g.bh, sw = g.ww / g.bw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int win = blockIdx.x / ns, split = blockIdx.x % ns;
  const int cells = (g.bh / ns) * g.bw;  // whole rows of base cells
  const int m_lo = split * cells;
  const int l_lo = split * (g.bh / ns) * sh * g.ww;
  const int l_n = (g.bh / ns) * sh * g.ww;  // its tokens, contiguous

  const float b0 = __bfloat162float(a.slb[0]);
  for (DivMod e(tid, kBlockThreads, c2); e.q < cells; e.next()) {
    const int m = e.q, ch = e.r;
    const bf16* vp = a.qv +
                     static_cast<long long>(
                         pixel_of(g, win, cell_token(g, m_lo + m))) * c +
                     c2 + ch;
    float acc = 0.f;
    for (int y = 0; y < sh; ++y)
      for (int x = 0; x < sw; ++x)
        acc = fmaf(__bfloat162float(a.slw[y * sw + x]),
                   __bfloat162float(vp[(y * g.W + x) * static_cast<long long>(
                       c)]),
                   acc);
    a.vs_scr[(static_cast<long long>(win) * bl + m_lo + m) * c2 + ch] =
        srk::round_to<bf16>(acc + b0);
  }

  float gacc[C2P / 16][C2P / 8][4];
#pragma unroll
  for (int i = 0; i < C2P / 16; ++i)
#pragma unroll
    for (int j = 0; j < C2P / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
  for (int l0 = 0; l0 < l_n; l0 += kRows) {
    __syncthreads();  // the previous chunk is no longer read
    for (int r = tid; r < kRows; r += kBlockThreads)
      pix[r] = l0 + r < l_n ? pixel_of(g, win, l_lo + l0 + r) : -1;
    __syncthreads();
    stage_rows<C2P>(rows, pix, a);
    __syncthreads();
    gram_steps<C2P>(rows + warp * 16 * QST, 1, gacc);
  }
  // the warps' partial Grams added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < C2P / 16; ++i)
#pragma unroll
        for (int j = 0; j < C2P / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* dst = gsum + (16 * i + gid + 8 * (e >> 1)) * C2P + 8 * j +
                         2 * tig + (e & 1);
            *dst = (w == 0 ? 0.f : *dst) + gacc[i][j][e];
          }
    }
    __syncthreads();
  }
  float* gp = a.gram_scr +
              (static_cast<long long>(win) * ns + split) * C2P * C2P;
  for (int e = tid; e < C2P * C2P; e += kBlockThreads) gp[e] = gsum[e];
}

// The SCC of kRows token rows a block, a warp's 16 rows in one window:
// corr_h, xs, xc and the output projection on the tensor cores. C2P: each
// half (q, v) padded to 32 or 64 channels.
template <int C2P>
__global__ void __launch_bounds__(kBlockThreads, C2P == 32 ? kMinBlocks : 1)
    mma_scc_block_kernel(SccArgs a) {
  constexpr int KS = C2P / 16;         // k16 steps of a half
  constexpr int NC = C2P / 8;          // n8 tiles of a half
  constexpr int QST = 2 * C2P + kPad;  // [q | v] rows, W_proj rows
  constexpr int VST = C2P + kPad;      // vs rows, corr_c rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geom& g = a.g;
  const int c = a.c, c2 = c / 2, heads = a.heads, d = c2 / heads;
  const int L = g.wh * g.ww, bl = g.bh * g.bw, blp = cells_padded(bl);
  const int tpw = tiles_per_window(L), wpb = kWarps / tpw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, r8 = lane & 7;
  bf16* qvs = reinterpret_cast<bf16*>(smem_raw);  // kRows x QST
  bf16* ws = qvs + kRows * QST;                   // 2 C2P x QST
  bf16* vs = ws + 2 * C2P * QST;                  // wpb x blp x VST
  bf16* cc = vs + wpb * blp * VST;                // wpb x C2P x VST
  int* pix = reinterpret_cast<int*>(cc + wpb * C2P * VST);  // kRows, -1 dead
  int* tok = pix + kRows;  // kRows: a row's token in its window
  const bf16 zero = __float2bfloat16(0.f);

  // row r: warp tile r / 16 is tile (r / 16) % tpw of window slot
  // (r / 16) / tpw; rows past a window's L or past the windows are dead
  const int win0 = blockIdx.x * wpb;
  for (int r = tid; r < kRows; r += kBlockThreads) {
    const int t = r / 16, slot = t / tpw;
    const int l = blockIdx.y * kRows + (t % tpw) * 16 + r % 16;
    const bool live = slot < wpb && win0 + slot < a.n_win && l < L;
    tok[r] = live ? l : 0;
    pix[r] = live ? pixel_of(g, win0 + slot, l) : -1;
  }
  // W_proj with its rows regrouped: xs's c2 rows at 0, xc's at C2P, zero
  // past them and past c columns
  for (int e = tid; e < 2 * C2P * C2P; e += kBlockThreads) {
    const int k = e / C2P, n = 2 * (e % C2P);
    const int kh = k % C2P, src = k < C2P ? kh : c2 + kh;
    const bool ok = kh < c2 && n < c;  // c is even
    if (a.qv_pairs) {
      *reinterpret_cast<uint32_t*>(ws + k * QST + n) =
          ok ? *reinterpret_cast<const uint32_t*>(a.wproj + src * c + n) : 0u;
    } else {
      ws[k * QST + n] = ok ? a.wproj[src * c + n] : zero;
      ws[k * QST + n + 1] = ok ? a.wproj[src * c + n + 1] : zero;
    }
  }
  __syncthreads();
  stage_rows<C2P>(qvs, pix, a);

  // vs and corr_c = round(q^T v / L) of the block's windows: reduced here
  // from the staged rows, or read from the reduction pass's scratch
  const float inv_l = 1.f / static_cast<float>(L);
  if (a.nsplit == 0) {
    __syncthreads();
    const float b0 = __bfloat162float(a.slb[0]);
    const int sh = g.wh / g.bh, sw = g.ww / g.bw;
    for (int e = tid; e < wpb * blp * C2P; e += kBlockThreads) {
      const int slot = e / (blp * C2P), m = (e / C2P) % blp, ch = e % C2P;
      float val = 0.f;
      if (m < bl && ch < c2) {
        const bf16* vp =
            qvs + (slot * tpw * 16 + cell_token(g, m)) * QST + C2P + ch;
        float acc = 0.f;
        for (int y = 0; y < sh; ++y)
          for (int x = 0; x < sw; ++x)
            acc = fmaf(__bfloat162float(a.slw[y * sw + x]),
                       __bfloat162float(vp[(y * g.ww + x) * QST]), acc);
        val = acc + b0;
      }
      vs[(slot * blp + m) * VST + ch] = __float2bfloat16(val);
    }
    // a warp a window: its Gram over the window's tiles
    if (warp < wpb) {
      float gacc[KS][NC][4];
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
      gram_steps<C2P>(qvs + warp * tpw * 16 * QST, tpw, gacc);
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(
                cc + (warp * C2P + 16 * i + gid + 8 * h) * VST + 8 * j +
                2 * tig) = mma::pack(gacc[i][j][2 * h] * inv_l,
                                     gacc[i][j][2 * h + 1] * inv_l);
    }
  } else {
    const float* vp = a.vs_scr + static_cast<long long>(win0) * bl * c2;
    for (int e = tid; e < blp * C2P; e += kBlockThreads) {
      const int m = e / C2P, ch = e % C2P;
      vs[m * VST + ch] =
          __float2bfloat16(m < bl && ch < c2 ? vp[m * c2 + ch] : 0.f);
    }
    const float* gp =
        a.gram_scr + static_cast<long long>(win0) * a.nsplit * C2P * C2P;
    for (int e = tid; e < C2P * C2P; e += kBlockThreads) {
      float acc = 0.f;
      for (int s = 0; s < a.nsplit; ++s) acc += gp[s * C2P * C2P + e];
      cc[(e / C2P) * VST + e % C2P] = __float2bfloat16(acc * inv_l);
    }
  }
  __syncthreads();

  const int slot = warp / tpw;
  if (slot >= wpb || pix[warp * 16] < 0) return;  // a dead tile; no barrier
  const bf16* rows = qvs + warp * 16 * QST;
  const bf16* vsw = vs + slot * blp * VST;
  const bf16* ccw = cc + slot * C2P * VST;
  const int a_off = (8 * (mi & 1) + r8) * QST + 8 * (mi >> 1);
  uint32_t qa[KS][4], va[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    mma::ldsm_x4(qa[ks], rows + a_off + 16 * ks);
    mma::ldsm_x4(va[ks], rows + a_off + C2P + 16 * ks);
  }

  // xs: per chunk of 16 base cells and per head, corr = q vs_h^T (vs^T as
  // B, masked to the head's channels) scaled, biased and rounded into the
  // A fragment of corr vs_h (vs as B, masked alike), added into the c2-wide
  // xs accumulators
  float xs[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[j][e] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  const int tk[2] = {tok[warp * 16 + gid], tok[warp * 16 + gid + 8]};
  for (int m0 = 0; m0 < blp; m0 += 16) {
    uint32_t vb[KS][4], vt[NC / 2][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma::ldsm_x4(vb[ks], vsw + (m0 + 8 * (mi >> 1) + r8) * VST + 16 * ks +
                               8 * (mi & 1));
#pragma unroll
    for (int np = 0; np < NC / 2; ++np)
      mma::ldsm_x4_trans(vt[np], vsw + (m0 + 8 * (mi & 1) + r8) * VST +
                                     16 * np + 8 * (mi >> 1));
    // the bias of head h's rows gid, gid + 8 and cells m0 + 8 jn + 2 tig,
    // + 1: loaded one head ahead of its use
    auto load_bias = [&](int h, float2 (&bv)[2][2]) {
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + 8 * jn + 2 * tig;
          const float* br =
              a.bias + (static_cast<long long>(h) * L + tk[hh]) * bl + m;
          bv[jn][hh] = make_float2(0.f, 0.f);
          if (a.vec_bias && m + 1 < bl) {
            bv[jn][hh] = __ldg(reinterpret_cast<const float2*>(br));
          } else {
            if (m < bl) bv[jn][hh].x = __ldg(br);
            if (m + 1 < bl) bv[jn][hh].y = __ldg(br + 1);
          }
        }
    };
    float2 bias_h[2][2];
    load_bias(0, bias_h);
    for (int h = 0; h < heads; ++h) {
      const int h0 = h * d, h1 = h0 + d;
      float2 bias_next[2][2];
      if (h + 1 < heads) load_bias(h + 1, bias_next);
      // the halves of a word whose channels ch, ch + 1 lie in the head
      auto keep = [&](int ch) {
        return (ch >= h0 && ch < h1 ? 0xffffu : 0u) |
               (ch + 1 >= h0 && ch + 1 < h1 ? 0xffff0000u : 0u);
      };
      float cr[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (16 * ks >= h1 || 16 * ks + 16 <= h0) continue;
        const uint32_t k0 = keep(16 * ks + 2 * tig);
        const uint32_t k1 = keep(16 * ks + 8 + 2 * tig);
        const uint32_t b00 = vb[ks][0] & k0, b01 = vb[ks][1] & k1;
        const uint32_t b10 = vb[ks][2] & k0, b11 = vb[ks][3] & k1;
        mma::mma_bf16(cr[0], qa[ks], b00, b01);
        mma::mma_bf16(cr[1], qa[ks], b10, b11);
      }
      uint32_t ca[4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ca[2 * jn + hh] =
              mma::pack(cr[jn][2 * hh] * inv_d + bias_h[jn][hh].x,
                        cr[jn][2 * hh + 1] * inv_d + bias_h[jn][hh].y);
          bias_h[jn][hh] = bias_next[jn][hh];
        }
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        if (8 * nt >= h1 || 8 * nt + 8 <= h0) continue;
        const int ch = 8 * nt + gid;
        const uint32_t k = ch >= h0 && ch < h1 ? 0xffffffffu : 0u;
        mma::mma_bf16(xs[nt], ca, vt[nt / 2][2 * (nt & 1)] & k,
                      vt[nt / 2][2 * (nt & 1) + 1] & k);
      }
    }
  }

  // xc = v corr_c^T (corr_c rows as B)
  float xc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t cb[4];
      mma::ldsm_x4(cb, ccw + (16 * np + 8 * (mi >> 1) + r8) * VST + 16 * ks +
                           8 * (mi & 1));
      mma::mma_bf16(xc[2 * np], va[ks], cb[0], cb[1]);
      mma::mma_bf16(xc[2 * np + 1], va[ks], cb[2], cb[3]);
    }

  // out = [round(xs) | round(xc)] W_proj + b_proj: the accumulators are
  // the A fragments of the projection, xs's k steps then xc's
  float o[2 * NC][4];
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  auto project = [&](const float(&src)[NC][4], int k0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4];
      af[0] = mma::pack(src[2 * ks][0], src[2 * ks][1]);
      af[1] = mma::pack(src[2 * ks][2], src[2 * ks][3]);
      af[2] = mma::pack(src[2 * ks + 1][0], src[2 * ks + 1][1]);
      af[3] = mma::pack(src[2 * ks + 1][2], src[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < NC; ++np) {
        uint32_t bw[4];
        mma::ldsm_x4_trans(bw, ws + (k0 + 16 * ks + 8 * (mi & 1) + r8) * QST +
                                   16 * np + 8 * (mi >> 1));
        mma::mma_bf16(o[2 * np], af, bw[0], bw[1]);
        mma::mma_bf16(o[2 * np + 1], af, bw[2], bw[3]);
      }
    }
  };
  project(xs, 0);
  project(xc, C2P);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = pix[warp * 16 + gid + 8 * hh];
    if (p < 0) continue;
    bf16* dst = a.out + static_cast<long long>(p) * c;
#pragma unroll
    for (int nt = 0; nt < 2 * NC; ++nt) {
      const int n = 8 * nt + 2 * tig;
      if (n >= c) continue;
      const float v0 = o[nt][2 * hh] + __bfloat162float(a.bproj[n]);
      if (n + 1 < c) {
        const float v1 = o[nt][2 * hh + 1] + __bfloat162float(a.bproj[n + 1]);
        if (a.pairs) {
          *reinterpret_cast<uint32_t*>(dst + n) = mma::pack(v0, v1);
        } else {
          dst[n] = __float2bfloat16(v0);
          dst[n + 1] = __float2bfloat16(v1);
        }
      } else {
        dst[n] = __float2bfloat16(v0);
      }
    }
  }
}

template <int C2P>
cudaError_t launch(const SccArgs& a, cudaStream_t stream) {
  const Geom& g = a.g;
  const int L = g.wh * g.ww, bl = g.bh * g.bw;
  cudaError_t err;
  if (a.nsplit) {
    const int rs = reduce_smem_bytes(a.c);
    err = srk::set_smem(mma_scc_reduce_kernel<C2P>, rs);
    if (err != cudaSuccess) return err;
    mma_scc_reduce_kernel<C2P><<<a.n_win * a.nsplit, kBlockThreads, rs,
                                 stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int smem = main_smem_bytes(L, bl, a.c);
  err = srk::set_smem(mma_scc_block_kernel<C2P>, smem);
  if (err != cudaSuccess) return err;
  const int wpb = windows_per_block(L);
  const dim3 grid((a.n_win + wpb - 1) / wpb,
                  L > kRows ? (L + kRows - 1) / kRows : 1);
  mma_scc_block_kernel<C2P><<<grid, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Bytes of dynamic shared memory the larger of the two kernels needs for a
// wh x ww window on a bh x bw base, c channels in heads heads; the wrapper
// holds this against the card's limit before it launches.
extern "C" int sr_scc_block_smem(int wh, int ww, int bh, int bw, int c,
                                 int heads) {
  const size_t main = main_smem_bytes(wh * ww, bh * bw, c, heads);
  const size_t red = reduce_smem_bytes(bh * bw, c);
  return static_cast<int>(main > red ? main : red);
}

// Float32 elements of scratch a window needs between the two launches (vs
// and the slices' partial Grams); 0 where the main kernel reduces the
// window itself, or for a shape sr_scc_block refuses.
extern "C" int sr_scc_block_scratch(int wh, int ww, int bh, int bw, int c,
                                    int heads) {
  if (!shape_ok(wh, ww, bh, bw, c, heads)) return 0;
  const int nsplit = reduce_splits(wh * ww, bh);
  if (nsplit == 0) return 0;
  return static_cast<int>(vs_floats(bh * bw, c, heads) +
                          static_cast<size_t>(nsplit) * (c / 2) * (c / 2));
}

// The FMA kernels. dtype: 0 float32; 1 (bf16) is refused, bf16 is
// sr_mma_scc_block's. bias (heads, L, baseL) is float32. scratch: float32,
// sr_scc_block_scratch(...) elements a window (never read where that is
// 0). Returns the cudaError_t of the launches.
extern "C" int sr_scc_block(int dtype, const void* qv, const void* slw,
                            const void* slb, const void* wproj,
                            const void* bproj, const void* bias,
                            void* scratch, void* out, int B, int H, int W,
                            int c, int heads, int wh, int ww, int bh, int bw,
                            void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch<float>(qv, slw, slb, wproj, bproj,
                       static_cast<const float*>(bias),
                       static_cast<float*>(scratch), out, B, H, W, c, heads,
                       wh, ww, bh, bw, static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory the larger of the two tensor-core kernels
// needs for a wh x ww window on a bh x bw base, c channels (heads do not
// matter); the wrapper holds this against the card's limit.
extern "C" int sr_mma_scc_block_smem(int wh, int ww, int bh, int bw, int c) {
  const int L = wh * ww;
  const int main = tc::main_smem_bytes(L, bh * bw, c);
  const int red = tc::splits(L, bh) ? tc::reduce_smem_bytes(c) : 0;
  return main > red ? main : red;
}

// Float32 elements of scratch a window needs between the tensor-core
// kernels' two launches (vs and the slices' partial Grams); 0 where the
// main kernel reduces the window itself, or for a shape sr_mma_scc_block
// refuses.
extern "C" int sr_mma_scc_block_scratch(int wh, int ww, int bh, int bw,
                                        int c, int heads) {
  if (!shape_ok(wh, ww, bh, bw, c, heads)) return 0;
  const int ns = tc::splits(wh * ww, bh), c2p = tc::half_width(c / 2);
  return ns ? bh * bw * (c / 2) + ns * c2p * c2p : 0;
}

// The SCC block in bf16 on the tensor cores: operands as sr_scc_block's,
// bf16 but the float32 bias; scratch: sr_mma_scc_block_scratch(...)
// float32 elements a window. Returns the cudaError_t of the launches.
extern "C" int sr_mma_scc_block(const void* qv, const void* slw,
                                const void* slb, const void* wproj,
                                const void* bproj, const void* bias,
                                void* scratch, void* out, int B, int H,
                                int W, int c, int heads, int wh, int ww,
                                int bh, int bw, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!shape_ok(wh, ww, bh, bw, c, heads) || B < 1 || H < 1 || W < 1 ||
      H % wh || W % ww)
    return cudaErrorInvalidValue;
  auto b16 = [](const void* p) { return static_cast<const bf16*>(p); };
  const int L = wh * ww, bl = bh * bw;
  tc::SccArgs a;
  a.qv = b16(qv);
  a.slw = b16(slw);
  a.slb = b16(slb);
  a.wproj = b16(wproj);
  a.bproj = b16(bproj);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.g = Geom{H, W, wh, ww, bh, bw, H / wh, W / ww};
  a.c = c;
  a.heads = heads;
  a.n_win = B * a.g.nwy * a.g.nwx;
  a.nsplit = tc::splits(L, bh);
  a.vs_scr = static_cast<float*>(scratch);
  a.gram_scr = a.vs_scr + static_cast<long long>(a.n_win) * bl * (c / 2);
  a.vec_bias = bl % 2 == 0 && (reinterpret_cast<uintptr_t>(bias) & 7) == 0;
  a.pairs = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  a.qv_pairs = c % 4 == 0 && (reinterpret_cast<uintptr_t>(qv) & 3) == 0 &&
               (reinterpret_cast<uintptr_t>(wproj) & 3) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tc::half_width(c / 2) == 32 ? tc::launch<32>(a, st)
                                     : tc::launch<64>(a, st);
}
