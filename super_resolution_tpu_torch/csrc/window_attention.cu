// Window attention with an additive bias on pre-cut windows, square or
// rectangular:
//
//   out[w, h] = softmax(q[w, h] k[w, h]^T * scale + bias[h]) v[w, h]
//   q, out (BW, heads, Nq, d); k, v (BW, heads, Nk, d); bias (heads, Nq, Nk)
//
// Replaces the TPU kernels of super_resolution_tpu/ops/pallas_attention.py:
// fused_attention (pallas_call at :105, kernel :48-66) and
// fused_attention_v3 (:186, kernel :127-149). The cast points are theirs:
// scores and softmax in float32, the scale applied to the float32 scores,
// p rounded to v's dtype before P @ V, the output rounded once.
//
// In bf16 both run on the tensor-core tile of mma_attention.cuh (which says
// what bounds it and how), with p = exp(s - m) rounded before P @ V
// unnormalised and the output divided by the float32 denominator, where the
// TPU kernels round the normalised p:
//
// fused_attention is mma_window_attention_kernel: a block per (group of
// windows, 64 query rows, head), an online softmax over key chunks whose
// bias tile every window of the group shares.
//
// fused_attention_v3 is mma_window_attention_v3_kernel. It keeps v3's
// identity: a block walks all heads, so a window's q, k and v of every head
// are read by one block. It computes fused_attention's function at its
// shape, so the same floors bound it: at ESC's chunk (100 windows, 4 heads,
// N 1024, d 16) the bound is 0.0438 ms (the softmax's elementwise work)
// and the 419 M exponentials take 0.1075 ms on the special-function units,
// against 0.027 ms of products on the tensor cores. Design: a block of four
// warps owns (kWindowGroup = 2 windows, 64 query rows) and loops over the
// heads; for each it loads the head's q fragments, streams k, v and the
// bias tile in 64-key chunks through the double-buffered cp.async stages,
// runs the online softmax and writes the head's output. The copies of the
// next step are in flight across a head boundary, so the pipeline does not
// drain between heads. The grid is (window groups, query blocks), windows
// fastest: the blocks that run together walk the same head's bias rows.
// ESC's chunk gives 800 blocks (fused_attention: 3,200), about two waves
// at three blocks an SM, so the last partial wave costs more here.
//
// In float32 both are the FMA kernels below, the exact check of the
// algorithm on the card; their entries refuse bf16. What bounds them: per
// (window, head) at ESC's shape (N 1024, d 16) the two products are 4 *
// 1024 * 1024 * 16 = 67 MFLOP against 4 * 1024 * 16 * 2 = 131 kB of q, k, v
// and out and a 4 MB float32 bias slice that every window of the head
// shares: compute-bound. They run both products as float32 FMA loops on
// the CUDA cores and are bound by them.
//
// Design, fused_attention (float32): one block per (window, head, 64 query
// rows). The TPU grid is (heads, window blocks) with several windows a program
// and zero windows padded on; here a block is a window's share, so nothing is
// padded. The head's k and v (Nk x d each) are loaded once into shared memory
// as float32 with d padded to 16 or 32; the block then walks its 64 query rows
// in tiles of 16, for each forming the 16 x Nk float32 score tile in shared
// memory (attention_tiles.cuh), so the Nq x Nk matrix never exists. At N 1024,
// d 16: 128 kB of k and v, 64 kB of scores, 9 kB of q tile and reduction space,
// 206 kB a block. The grid puts windows fastest, then query blocks, heads
// slowest: blocks that run together share one head's bias rows, which the L2
// holds (4 MB a head).
//
// Design, fused_attention_v3 (float32): the same tile loop with one block
// per window that walks all heads and all query tiles, so a window's q, k
// and v are read from device memory exactly once (the TPU version's reason
// to exist: its v2 re-fetched k and v per head).
#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kQT = 16;       // query rows of a score tile
constexpr int kQBlock = 64;   // query rows a fused_attention block owns

struct Smem {
  float *ks, *vs, *sc, *qs, *red;
};

template <int DP>
__device__ __forceinline__ Smem carve(float* smem, int nk) {
  const int nk4 = srk::round_up4(nk);
  Smem s;
  s.ks = smem;
  s.vs = s.ks + nk4 * DP;
  s.sc = s.vs + nk4 * DP;
  s.qs = s.sc + kQT * srk::score_stride(nk);
  s.red = s.qs + kQT * DP;
  return s;
}

size_t smem_bytes(int nk, int dp) {
  return sizeof(float) * (2 * srk::round_up4(nk) * dp +
                          kQT * srk::score_stride(nk) + kQT * dp +
                          srk::kTileWarps * kQT * dp);
}

// Query rows [q_lo, q_hi) of one (window, head) whose k and v lie in s.
template <typename T, int DP>
__device__ __forceinline__ void attend_rows(const Smem& s, const T* qh,
                                            const float* bh, T* oh, int q_lo,
                                            int q_hi, int nk, int d,
                                            float scale) {
  for (int q0 = q_lo; q0 < q_hi; q0 += kQT) {
    const int qt = min(kQT, q_hi - q0);
    srk::load_rows<T, DP>(s.qs, qt, kQT, d, [&](int i) {
      return qh + static_cast<long long>(q0 + i) * d;
    });
    __syncthreads();  // also covers the k and v loads before the first tile
    srk::attend_tile<T, DP, kQT>(
        s.qs, qt, s.ks, s.vs, nk, s.sc, s.red, d, scale,
        [&](int i, int j) {
          return bh[static_cast<long long>(q0 + i) * nk + j];
        },
        [&](int i, int t, float o) {
          oh[static_cast<long long>(q0 + i) * d + t] = srk::from_f<T>(o);
        });
  }
}

template <typename T, int DP>
__device__ __forceinline__ void load_kv(const Smem& s, const T* kh,
                                        const T* vh, int nk, int d) {
  const int nk4 = srk::round_up4(nk);
  srk::load_rows<T, DP>(s.ks, nk, nk4, d, [&](int j) {
    return kh + static_cast<long long>(j) * d;
  });
  srk::load_rows<T, DP>(s.vs, nk, nk4, d, [&](int j) {
    return vh + static_cast<long long>(j) * d;
  });
}

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ bias,
                           T* __restrict__ out, int bw, int heads, int nq,
                           int nk, int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<DP>(smem, nk);
  const int w = blockIdx.x % bw;
  const int qb = blockIdx.x / bw;
  const int h = blockIdx.y;
  const long long wh = static_cast<long long>(w) * heads + h;
  load_kv<T, DP>(s, k + wh * nk * d, v + wh * nk * d, nk, d);
  attend_rows<T, DP>(s, q + wh * nq * d,
                     bias + static_cast<long long>(h) * nq * nk,
                     out + wh * nq * d, qb * kQBlock,
                     min(nq, (qb + 1) * kQBlock), nk, d, scale);
}

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    fused_attention_v3_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int heads, int nq, int nk,
                              int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<DP>(smem, nk);
  for (int h = 0; h < heads; ++h) {
    const long long wh = static_cast<long long>(blockIdx.x) * heads + h;
    // the previous head's last tile ended with a block barrier
    load_kv<T, DP>(s, k + wh * nk * d, v + wh * nk * d, nk, d);
    attend_rows<T, DP>(s, q + wh * nq * d,
                       bias + static_cast<long long>(h) * nq * nk,
                       out + wh * nq * d, 0, nq, nk, d, scale);
  }
}

template <typename T, int DP>
cudaError_t launch(bool v3, const void* q, const void* k, const void* v,
                   const float* bias, void* out, int bw, int heads, int nq,
                   int nk, int d, float scale, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;  // bf16: the sr_mma_window_attention* entries
  } else {
    const size_t smem = smem_bytes(nk, DP);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    T* ot = static_cast<T*>(out);
    cudaError_t err;
    if (v3) {
      err = srk::set_smem(fused_attention_v3_kernel<T, DP>, smem);
      if (err != cudaSuccess) return err;
      fused_attention_v3_kernel<T, DP>
          <<<bw, srk::kTileThreads, smem, stream>>>(qt, kt, vt, bias, ot,
                                                    heads, nq, nk, d, scale);
    } else {
      err = srk::set_smem(fused_attention_kernel<T, DP>, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(bw * ((nq + kQBlock - 1) / kQBlock), heads);
      fused_attention_kernel<T, DP><<<grid, srk::kTileThreads, smem, stream>>>(
          qt, kt, vt, bias, ot, bw, heads, nq, nk, d, scale);
    }
    return cudaGetLastError();
  }
}

int dispatch(bool v3, int dtype, const void* q, const void* k, const void* v,
             const void* bias, void* out, int bw, int heads, int nq, int nk,
             int d, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (d < 1 || d > 32 || bw < 1 || heads < 1 || heads > 65535 || nq < 1 ||
      nk < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return d <= 16 ? launch<float, 16>(v3, q, k, v, bf, out, bw, heads, nq,
                                       nk, d, scale, st)
                   : launch<float, 32>(v3, q, k, v, bf, out, bw, heads, nq,
                                       nk, d, scale, st);
  return d <= 16 ? launch<__nv_bfloat16, 16>(v3, q, k, v, bf, out, bw, heads,
                                             nq, nk, d, scale, st)
                 : launch<__nv_bfloat16, 32>(v3, q, k, v, bf, out, bw, heads,
                                             nq, nk, d, scale, st);
}

// Pre-cut windows as rows of the tensor-core tile (mma_attention.cuh).
struct WindowRows {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* out;
  int heads, nq, nk, d;
  struct Win {
    long long qo, ko;  // element offsets of the (window, head) q and k
  };
  __device__ __forceinline__ Win win(int w, int h) const {
    const long long wh = static_cast<long long>(w) * heads + h;
    return Win{wh * nq * d, wh * nk * d};
  }
  __device__ __forceinline__ const __nv_bfloat16* row(const Win& w, int part,
                                                      int i) const {
    if (part == 0) return q + w.qo + static_cast<long long>(i) * d;
    return (part == 1 ? k : v) + w.ko + static_cast<long long>(i) * d;
  }
  __device__ __forceinline__ __nv_bfloat16* out_row(const Win& w,
                                                    int i) const {
    return out + w.qo + static_cast<long long>(i) * d;
  }
};

template <int DP>
__global__ void __launch_bounds__(srk::mma::kThreads)
    mma_window_attention_kernel(WindowRows rows,
                                const float* __restrict__ bias, int bw,
                                int nq, int nk, int d, float scale,
                                int vec_kv, int vec_bias) {
  srk::mma::attention_block<DP>(rows, bias, bw, nq, nk, d, scale,
                                vec_kv != 0, vec_bias != 0);
}

template <int DP>
__global__ void __launch_bounds__(srk::mma::kThreads)
    mma_window_attention_v3_kernel(WindowRows rows,
                                   const float* __restrict__ bias, int bw,
                                   int nq, int nk, int d, float scale,
                                   int vec_kv, int vec_bias) {
  srk::mma::head_walk_block<DP>(rows, bias, bw, rows.heads, nq, nk, d, scale,
                                vec_kv != 0, vec_bias != 0);
}

// v3: a block walks the heads, the grid has no head axis
template <int DP>
cudaError_t launch_mma(bool v3, const WindowRows& rows, const float* bias,
                       int bw, int nq, int nk, int d, float scale,
                       bool vec_kv, bool vec_bias, cudaStream_t stream) {
  constexpr int G = srk::mma::kWindowGroup;
  const int smem = srk::mma::smem_bytes(DP);
  auto kernel = v3 ? mma_window_attention_v3_kernel<DP>
                   : mma_window_attention_kernel<DP>;
  cudaError_t err = srk::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((bw + G - 1) / G,
                  (nq + srk::mma::kQRows - 1) / srk::mma::kQRows,
                  v3 ? 1 : rows.heads);
  kernel<<<grid, srk::mma::kThreads, smem, stream>>>(
      rows, bias, bw, nq, nk, d, scale, vec_kv, vec_bias);
  return cudaGetLastError();
}

int dispatch_mma(bool v3, const void* q, const void* k, const void* v,
                 const void* bias, void* out, int bw, int heads, int nq,
                 int nk, int d, float scale, void* stream) {
  if (d < 1 || d > 32 || bw < 1 || heads < 1 || heads > 65535 || nq < 1 ||
      nk < 1 || (nq + srk::mma::kQRows - 1) / srk::mma::kQRows > 65535)
    return cudaErrorInvalidValue;
  const int dp = d <= 16 ? 16 : 32;
  using bf = __nv_bfloat16;
  const WindowRows rows{static_cast<const bf*>(q), static_cast<const bf*>(k),
                        static_cast<const bf*>(v), static_cast<bf*>(out),
                        heads, nq, nk, d};
  // rows of d == dp values start on 16-byte boundaries if the tensors do
  const bool vec_kv =
      d == dp && srk::mma::aligned16(k) && srk::mma::aligned16(v);
  const bool vec_bias = nk % 4 == 0 && srk::mma::aligned16(bias);
  const float* bf32 = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dp == 16 ? launch_mma<16>(v3, rows, bf32, bw, nq, nk, d, scale,
                                   vec_kv, vec_bias, st)
                  : launch_mma<32>(v3, rows, bf32, bw, nq, nk, d, scale,
                                   vec_kv, vec_bias, st);
}

}  // namespace

// Bytes of dynamic shared memory a block of the bf16 tensor-core kernels
// (fused_attention, fused_attention_v3, msa_flash_attention,
// msa_qtile_attention) needs at head dim d, whatever the window.
extern "C" int sr_mma_attention_smem(int d) {
  return srk::mma::smem_bytes(d <= 16 ? 16 : 32);
}

// fused_attention (sr_mma_window_attention) and fused_attention_v3
// (sr_mma_window_attention_v3) in bf16 on the tensor cores. q, out (bw,
// heads, nq, d); k, v (bw, heads, nk, d) bf16; bias (heads, nq, nk)
// float32. Return the cudaError_t of the launch.
extern "C" int sr_mma_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int bw, int heads, int nq,
                                       int nk, int d, float scale,
                                       void* stream) {
  return dispatch_mma(false, q, k, v, bias, out, bw, heads, nq, nk, d, scale,
                      stream);
}

extern "C" int sr_mma_window_attention_v3(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* out, int bw, int heads,
                                          int nq, int nk, int d, float scale,
                                          void* stream) {
  return dispatch_mma(true, q, k, v, bias, out, bw, heads, nq, nk, d, scale,
                      stream);
}

// Bytes of dynamic shared memory a block of either FMA kernel (float32)
// needs for nk keys of head dim d; the wrappers hold this against the
// card's limit.
extern "C" int sr_window_attention_smem(int nk, int d) {
  return static_cast<int>(smem_bytes(nk, d <= 16 ? 16 : 32));
}

// The FMA kernels. dtype: 0 float32; 1 (bf16) is refused, bf16 is the
// sr_mma_window_attention* entries'. q, out (bw, heads, nq, d); k, v
// (bw, heads, nk, d); bias (heads, nq, nk) float32. Returns the
// cudaError_t of the launch.
extern "C" int sr_fused_attention(int dtype, const void* q, const void* k,
                                  const void* v, const void* bias, void* out,
                                  int bw, int heads, int nq, int nk, int d,
                                  float scale, void* stream) {
  return dispatch(false, dtype, q, k, v, bias, out, bw, heads, nq, nk, d,
                  scale, stream);
}

extern "C" int sr_fused_attention_v3(int dtype, const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int bw, int heads, int nq,
                                     int nk, int d, float scale,
                                     void* stream) {
  return dispatch(true, dtype, q, k, v, bias, out, bw, heads, nq, nk, d,
                  scale, stream);
}
