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
// roll stays with the caller. The cast points are the TPU kernel's: scores
// and softmax in float32, the scale applied to the float32 scores, p
// rounded to the input dtype before P @ V, the output rounded once.
//
// What bounds it on the H100: at ATD's chunk (four 160 x 160 tiles, 400
// windows of N 256, 6 heads of d 35) the two products are 4 * 256 * 256 *
// 35 = 9.2 MFLOP a (window, head) against 72 kB of bf16 q, k, v and out:
// 22 GFLOP against 0.17 GB of image plus 1.6 MB of bias and 26 MB of mask.
// On the tensor cores' scale that is bound by bytes; this first version
// runs both products as float32 FMA loops on the CUDA cores and is bound by
// them.
//
// Design: one block per (window, head, 64 query rows), the layout of
// fused_attention (window_attention.cu) with the window's rows read
// straight from the image by index, as large_window_attention.cu reads
// them. The TPU grid is one program per window that walks the heads in
// sequence with the whole bias in VMEM; here that would be 400 long blocks
// for 132 SMs at a chunk and 16 blocks for a 64 x 64 request. The head's k
// and v (N x d each) go to shared memory once as float32 with d padded to
// 16, 32 or 48 (d 35 -> 48); the block then walks its query rows in
// tiles of 16, each a 16 x N float32 score tile in shared memory
// (attention_tiles.cuh). At N 256, d 35: 96 kB of k and v, 16 kB of scores,
// 27 kB of q tile and reduction space, 143 kB a block. Windows are fastest
// in the grid, then query blocks, heads slowest: blocks that run together
// share one head's bias rows in the L2; a window's mask slice (256 kB) is
// read by its 6 heads' blocks, 26 MB in all, which the L2 holds.
#include "attention_tiles.cuh"

namespace {

constexpr int kQT = 16;       // query rows of a score tile
constexpr int kQBlock = 64;   // query rows a block owns

size_t smem_bytes(int n, int dp) {
  return sizeof(float) * (2 * srk::round_up4(n) * dp +
                          kQT * srk::score_stride(n) + kQT * dp +
                          srk::kTileWarps * kQT * dp);
}

int pad_of(int d) { return (d + 15) / 16 * 16; }

template <typename T, int DP>
__global__ void __launch_bounds__(srk::kTileThreads)
    msa_attention_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int n_mask,
                         T* __restrict__ out, int windows, int H, int W, int C,
                         int heads, int ws, float scale) {
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
  srk::load_rows_any<T, DP>(ks, n, n4, d,
                            [&](int j) { return channel(j, 1); });
  srk::load_rows_any<T, DP>(vs, n, n4, d,
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
    srk::load_rows_any<T, DP>(qs, qt, kQT, d,
                              [&](int i) { return channel(q0 + i, 0); });
    __syncthreads();  // also covers the k and v loads before the first tile
    srk::attend_tile<T, DP, kQT>(
        qs, qt, ks, vs, n, sc, red, d, scale,
        [&](int i, int j) {
          const long long at = static_cast<long long>(q0 + i) * n + j;
          return mw == nullptr ? bh[at] : bh[at] + mw[at];
        },
        [&](int i, int t, float o) {
          out[win.pixel(q0 + i) * C + h * d + t] = srk::from_f<T>(o);
        });
  }
}

template <typename T, int DP>
cudaError_t launch(const void* qkv, const float* bias, const float* mask,
                   int n_mask, void* out, int B, int H, int W, int C,
                   int heads, int ws, float scale, cudaStream_t stream) {
  const int n = ws * ws;
  const int windows = B * (H / ws) * (W / ws);
  const size_t smem = smem_bytes(n, DP);
  cudaError_t err = srk::set_smem(msa_attention_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(windows * ((n + kQBlock - 1) / kQBlock), heads);
  msa_attention_kernel<T, DP><<<grid, srk::kTileThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, mask, n_mask, static_cast<T*>(out),
      windows, H, W, C, heads, ws, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_padded(int dp, const void* qkv, const float* bias,
                          const float* mask, int n_mask, void* out, int B,
                          int H, int W, int C, int heads, int ws, float scale,
                          cudaStream_t stream) {
  switch (dp) {
    case 16:
      return launch<T, 16>(qkv, bias, mask, n_mask, out, B, H, W, C, heads,
                           ws, scale, stream);
    case 32:
      return launch<T, 32>(qkv, bias, mask, n_mask, out, B, H, W, C, heads,
                           ws, scale, stream);
    case 48:
      return launch<T, 48>(qkv, bias, mask, n_mask, out, B, H, W, C, heads,
                           ws, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory a block needs for window ws and head dim
// d; the wrapper holds this against the card's limit.
extern "C" int sr_msa_attention_smem(int ws, int d) {
  return static_cast<int>(smem_bytes(ws * ws, pad_of(d)));
}

// dtype: 0 float32, 1 bfloat16. qkv (B, H, W, 3C), out (B, H, W, C), bias
// (heads, ws^2, ws^2) float32, mask (n_mask, ws^2, ws^2) float32 with
// n_mask 1 or the windows of one image, or null for no mask. Head dims up
// to 48. Returns the cudaError_t of the launch.
extern "C" int sr_msa_attention(int dtype, const void* qkv, const void* bias,
                                const void* mask, int n_mask, void* out,
                                int B, int H, int W, int C, int heads, int ws,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const float* mf = static_cast<const float*>(mask);
  if (heads < 1 || heads > 65535 || C % heads || ws < 1 || H % ws || W % ws ||
      B < 1 || dtype < 0 || dtype > 1 || C / heads > 48)
    return cudaErrorInvalidValue;
  if (mf != nullptr && n_mask != 1 && n_mask != (H / ws) * (W / ws))
    return cudaErrorInvalidValue;
  const int dp = pad_of(C / heads);
  if (dtype == 0)
    return launch_padded<float>(dp, qkv, bf, mf, n_mask, out, B, H, W, C,
                                heads, ws, scale, st);
  return launch_padded<__nv_bfloat16>(dp, qkv, bf, mf, n_mask, out, B, H, W,
                                      C, heads, ws, scale, st);
}
