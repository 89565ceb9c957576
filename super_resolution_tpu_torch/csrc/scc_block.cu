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
// bytes (the image in and out, the bias once). Head dim 5 and halves of 30
// channels fit no MMA tile and no 16-byte load of the image, so every
// product is a float32 FMA loop; what it really waits for is the instruction
// rate of those loops and the latency of shared memory, so the design keeps
// many warps on an SM.
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
#include "common.cuh"

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

// (e / n, e % n) of e = start + k * step for k = 0, 1, ..., advanced without a
// division: the index arithmetic of the loops below would otherwise cost
// more than their products (20 instructions a division against 5 FMAs).
struct DivMod {
  int q, r, dq, dr, n;
  __device__ __forceinline__ DivMod(int start, int step, int n_)
      : q(start / n_), r(start % n_), dq(step / n_), dr(step % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= n) {
      r -= n;
      ++q;
    }
  }
};

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

// dtype: 0 float32, 1 bfloat16. bias (heads, L, baseL) is float32. scratch:
// float32, sr_scc_block_scratch(...) elements a window (never read where
// that is 0). Returns the cudaError_t of the launch.
extern "C" int sr_scc_block(int dtype, const void* qv, const void* slw,
                            const void* slb, const void* wproj,
                            const void* bproj, const void* bias,
                            void* scratch, void* out, int B, int H, int W,
                            int c, int heads, int wh, int ww, int bh, int bw,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(qv, slw, slb, wproj, bproj, bf, scr, out, B, H, W, c,
                         heads, wh, ww, bh, bw, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qv, slw, slb, wproj, bproj, bf, scr, out, B,
                                 H, W, c, heads, wh, ww, bh, bw, st);
  return cudaErrorInvalidValue;
}
