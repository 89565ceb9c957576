// Tile routines of the attention kernels (window_attention.cu,
// large_window_attention.cu, msa_attention.cu, psa_block.cu): one block of
// kTileThreads threads works on a tile of QT query rows of one (window,
// head) against a range of keys that lies in shared memory.
//
//   Window        where the tokens of a ws x ws window lie in an image
//   load_rows     rows of d values -> (rows x DP) float32, zero padded
//   load_rows_any the same, with a row's address computed once per eight
//                 threads where d is no padded width (d 35, 30, 12, 10)
//   score_chunk   sc[i][col0 + j] = q_i . k_j * scale + bias(i, col0 + j)
//   softmax_tile  exact row softmax, p rounded to T (the reference's cast)
//   pv_chunk      acc += p[:, col0 : col0 + kc] @ v, keys split over warps
//   pv_reduce     sums the warps' partial tiles and hands out each value
//
// Everything in shared memory is float32; DP is the head dim padded with
// zeros to a multiple of 16 (16 or 32 in the kernels on cut windows and the
// large-window kernels, up to 48 in msa_attention.cu), so the inner loops
// carry no bounds test and read 8 or 16 bytes at a time. Both products are
// float32 FMA loops on the CUDA cores.
//
// score_chunk: a thread owns a key, keeps its DP values in registers and
// walks the tile's queries, whose values every lane reads from the same
// address (a broadcast). Its bias values come from device memory or the L2,
// one row apart, so it asks for kBiasRows of them at once and forms those
// rows' scores while they arrive: a load a row would leave the tile waiting
// one trip to the L2 per row, which eight warps a block do not hide.
// pv_chunk: a warp owns every eighth group of four
// keys; a lane owns QT/4 rows (ri, ri + 4, ...) and DP/8 columns, so the
// four rows a warp reads in one instruction are neighbours in the padded
// score tile (row stride: keys rounded up to 4, plus 4) and fall in
// different banks. The eight warps' partial tiles meet in pv_reduce.
#pragma once

#include "common.cuh"

namespace srk {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
// bias values a thread of score_chunk asks for before it uses the first
constexpr int kBiasRows = 16;

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// Row stride of a score tile over n keys.
__host__ __device__ inline int score_stride(int n) { return round_up4(n) + 4; }

// Where the tokens of a block's window lie in a (B, H, W, .) image.
struct Window {
  int ws, W;
  long long first;  // pixel index of the window's first token
  __device__ __forceinline__ long long pixel(int tok) const {
    return first + static_cast<long long>(tok / ws) * W + tok % ws;
  }
};

// Window widx of all images' windows, counted image by image, row by row.
__device__ __forceinline__ Window window_of(int widx, int H, int W, int ws) {
  const int nwx = W / ws, nw = (H / ws) * nwx;
  const int b = widx / nw, wi = widx % nw;
  Window win;
  win.ws = ws;
  win.W = W;
  win.first =
      (static_cast<long long>(b) * H + (wi / nwx) * ws) * W + (wi % nwx) * ws;
  return win;
}

// dst[j * DP + t] = row_ptr(j)[t] for j < rows, t < d; 0 up to rows_pad, DP.
// Where d == DP a row is a whole number of 16-byte pieces: a thread then
// takes one piece (8 bf16 or 4 float32 values) with one load, if its
// address is aligned, and computes the row's address once for it.
template <typename T, int DP, typename FR>
__device__ __forceinline__ void load_rows(float* dst, int rows, int rows_pad,
                                          int d, FR row_ptr) {
  if (d == DP) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int PIECES = DP / VEC;
    for (int e = threadIdx.x; e < rows_pad * PIECES; e += blockDim.x) {
      const int j = e / PIECES;
      float* o = dst + j * DP + (e % PIECES) * VEC;
      float val[VEC];
      if (j >= rows) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) val[u] = 0.f;
      } else {
        const T* p = row_ptr(j) + (e % PIECES) * VEC;
        if ((reinterpret_cast<unsigned long long>(p) & 15ull) == 0) {
          const uint4 raw = *reinterpret_cast<const uint4*>(p);
          const T* packed = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < VEC; ++u) val[u] = to_f(packed[u]);
        } else {
#pragma unroll
          for (int u = 0; u < VEC; ++u) val[u] = to_f(p[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(o + u) =
            make_float4(val[u], val[u + 1], val[u + 2], val[u + 3]);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows_pad * DP; e += blockDim.x) {
    const int j = e / DP, t = e % DP;
    dst[e] = (j < rows && t < d) ? to_f(row_ptr(j)[t]) : 0.f;
  }
}

// load_rows for any d <= DP: where d < DP eight threads share a row, so its
// address (a division where the rows are pixels of a window) is computed
// once for DP / 8 values a thread and not once a value.
template <typename T, int DP, typename FR>
__device__ __forceinline__ void load_rows_any(float* dst, int rows,
                                              int rows_pad, int d,
                                              FR row_ptr) {
  if (d == DP) {
    load_rows<T, DP>(dst, rows, rows_pad, d, row_ptr);
    return;
  }
  for (int e = threadIdx.x; e < rows_pad * 8; e += blockDim.x) {
    const int j = e >> 3;
    const T* p = j < rows ? row_ptr(j) : nullptr;
    // DP / 8 loads in flight at once: one trip to the L2 a row, not one a
    // value
    float val[DP / 8];
#pragma unroll
    for (int u = 0; u < DP / 8; ++u) {
      const int t = (e & 7) + 8 * u;
      val[u] = (p != nullptr && t < d) ? to_f(p[t]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < DP / 8; ++u) dst[j * DP + (e & 7) + 8 * u] = val[u];
  }
}

// Scores of qt query rows (qs, qt x DP) against kc keys (ks, kc x DP) into
// columns [col0, col0 + kc) of the score tile sc (row stride ld).
// bias_at(i, j) is the additive float32 term of tile row i and key j.
template <int DP, typename FB>
__device__ __forceinline__ void score_chunk(const float* qs, int qt,
                                            const float* ks, int kc,
                                            float* sc, int ld, int col0,
                                            float scale, FB bias_at) {
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    float kr[DP];
    const float4* kp = reinterpret_cast<const float4*>(ks + j * DP);
#pragma unroll
    for (int t = 0; t < DP / 4; ++t) {
      const float4 kv = kp[t];
      kr[4 * t] = kv.x;
      kr[4 * t + 1] = kv.y;
      kr[4 * t + 2] = kv.z;
      kr[4 * t + 3] = kv.w;
    }
    for (int i0 = 0; i0 < qt; i0 += kBiasRows) {
      float b[kBiasRows];
#pragma unroll
      for (int u = 0; u < kBiasRows; ++u)
        b[u] = (i0 + u < qt) ? bias_at(i0 + u, col0 + j) : 0.f;
#pragma unroll
      for (int u = 0; u < kBiasRows; ++u) {
        const int i = i0 + u;
        if (i < qt) {
          const float4* qp = reinterpret_cast<const float4*>(qs + i * DP);
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < DP / 4; ++t) {
            const float4 qv = qp[t];
            acc = fmaf(qv.x, kr[4 * t], acc);
            acc = fmaf(qv.y, kr[4 * t + 1], acc);
            acc = fmaf(qv.z, kr[4 * t + 2], acc);
            acc = fmaf(qv.w, kr[4 * t + 3], acc);
          }
          sc[i * ld + col0 + j] = acc * scale + b[u];
        }
      }
    }
  }
}

// Exact softmax of the first qt rows of sc over n keys, one warp per row;
// the probabilities are divided by the sum and rounded to T, as the
// reference casts p to v's dtype before P @ V. Columns [n, round_up4(n))
// are set to 0 for pv_chunk.
template <typename T>
__device__ __forceinline__ void softmax_tile(float* sc, int qt, int n,
                                             int ld) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int n4 = round_up4(n);
  for (int r = threadIdx.x >> 5; r < qt; r += nwarps) {
    float* row = sc + r * ld;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / sum);
    for (int j = n + lane; j < n4; j += 32) row[j] = 0.f;
  }
}

// acc += P[:, col0 : col0 + kc4] @ V for this lane's rows and columns and
// this warp's keys. vs holds kc4 rows of DP values (kc4 a multiple of 4,
// rows past the chunk's keys zero); col0 is a multiple of 4.
template <int DP, int QT>
__device__ __forceinline__ void pv_chunk(const float* sc, int ld, int col0,
                                         const float* vs, int kc4,
                                         float (&acc)[QT / 4][DP / 8]) {
  constexpr int RPL = QT / 4, CPL = DP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ri = lane >> 3, ci = lane & 7;
  for (int j0 = 4 * warp; j0 < kc4; j0 += 4 * nwarps) {
    float p[RPL][4];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(
          sc + (ri + 4 * r) * ld + col0 + j0);
      p[r][0] = pv.x;
      p[r][1] = pv.y;
      p[r][2] = pv.z;
      p[r][3] = pv.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* vr = vs + (j0 + kk) * DP + ci * CPL;
      float v[CPL];
      if constexpr (CPL % 4 == 0) {
#pragma unroll
        for (int u = 0; u < CPL; u += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + u);
          v[u] = vv.x;
          v[u + 1] = vv.y;
          v[u + 2] = vv.z;
          v[u + 3] = vv.w;
        }
      } else {
        static_assert(CPL % 2 == 0, "DP must be a multiple of 16");
#pragma unroll
        for (int u = 0; u < CPL; u += 2) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + u);
          v[u] = vv.x;
          v[u + 1] = vv.y;
        }
      }
#pragma unroll
      for (int r = 0; r < RPL; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(p[r][kk], v[c], acc[r][c]);
    }
  }
}

template <int DP, int QT>
__device__ __forceinline__ void zero_acc(float (&acc)[QT / 4][DP / 8]) {
#pragma unroll
  for (int r = 0; r < QT / 4; ++r)
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) acc[r][c] = 0.f;
}

// Sum the warps' partial (QT x DP) tiles through red (kTileWarps x QT x DP
// floats) and call store(i, t, sum) for every row i < qt and column t < d.
// Ends with a block barrier: every shared buffer may be reused after it.
template <int DP, int QT, typename FS>
__device__ __forceinline__ void pv_reduce(const float (&acc)[QT / 4][DP / 8],
                                          float* red, int qt, int d,
                                          FS store) {
  constexpr int RPL = QT / 4, CPL = DP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ri = lane >> 3, ci = lane & 7;
#pragma unroll
  for (int r = 0; r < RPL; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red[(warp * QT + ri + 4 * r) * DP + ci * CPL + c] = acc[r][c];
  __syncthreads();
  for (int e = threadIdx.x; e < QT * DP; e += blockDim.x) {
    const int i = e / DP, t = e % DP;
    if (i < qt && t < d) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += red[(w * QT + i) * DP + t];
      store(i, t, sum);
    }
  }
  __syncthreads();
}

// One tile of exact attention against keys and values that are whole in
// shared memory (ks, vs: round_up4(nk) x DP): scores, softmax, P @ V.
// qs (QT x DP) holds the tile's qt query rows; store(i, t, o) gets channel
// t of tile row i. Ends with a block barrier.
template <typename T, int DP, int QT, typename FB, typename FS>
__device__ __forceinline__ void attend_tile(const float* qs, int qt,
                                            const float* ks, const float* vs,
                                            int nk, float* sc, float* red,
                                            int d, float scale, FB bias_at,
                                            FS store) {
  const int ld = score_stride(nk);
  score_chunk<DP>(qs, qt, ks, nk, sc, ld, 0, scale, bias_at);
  __syncthreads();
  softmax_tile<T>(sc, qt, nk, ld);
  __syncthreads();
  float acc[QT / 4][DP / 8];
  zero_acc<DP, QT>(acc);
  pv_chunk<DP, QT>(sc, ld, 0, vs, round_up4(nk), acc);
  pv_reduce<DP, QT>(acc, red, qt, d, store);
}

}  // namespace srk
