// The front LayerNorm of a fork-HAT HAB, NHWC, with the ESC slab split off
// in the same pass:
//
//   ln1 = LN(x)                 (tokens, C), float32 statistics, rounded to T
//   x1  = ln1[:, :pdim]         (tokens, pdim), a compact copy
//
// Replaces the TPU kernel super_resolution_tpu/ops/pallas_hab.py: ln_split
// (pallas_call at :315). That kernel works on row tiles of the image and
// needs H to be a multiple of the tile; here a token is a token, so any B,
// H and W go through.
//
// What bounds it on the H100: bytes. Per token it reads C values and
// writes C + pdim, with a handful of operations each; at C 180, pdim 16 in
// bf16 that is 752 bytes a token.
//
// Two kernels, one a dtype, so nothing falls back from one to the other:
//
// - bf16, `ln_split_vec_kernel` (entry sr_ln_split_vec): a group of 16
//   lanes takes one token, a warp two. Each lane holds NV vectors of V
//   channels in registers (V = 4, 8-byte loads, where C and the pointers
//   allow; else 4-byte or 2-byte ones), interleaved across the group so
//   that its loads are contiguous: at C 180 the 45 vectors fill 45 of the
//   group's 48 slots. The row is read once from HBM; the mean, then the
//   centred variance, come from the registers through four shuffles each.
//   A lane keeps gamma and beta of its own channels in registers for every
//   token it takes: the grid holds as many blocks as fit on the card at
//   once, and each group walks the tokens, loading its next token's row
//   before it normalises the current one, so a lane has two rows of loads
//   in flight. ln1 and x1 leave in the same vector stores (x1 in element
//   stores where pdim is no multiple of V).
// - float32, `ln_split_kernel` (entry sr_ln_split), the first version and
//   the exact check on the card: one warp a token, the lanes striding over
//   the channels, the second and third reads of the row from L1. Its entry
//   refuses bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ln_split_kernel(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ ln1,
                    float* __restrict__ x1, int n_tok, int C, int pdim,
                    float eps) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tok >= n_tok) return;  // warp-uniform
  const float* xr = x + static_cast<long long>(tok) * C;
  float mu, rstd;
  srk::warp_ln_stats([&](int c) { return xr[c]; }, C, eps, mu, rstd);
  for (int c = lane; c < C; c += 32) {
    const float y = (xr[c] - mu) * rstd * gamma[c] + beta[c];
    ln1[static_cast<long long>(tok) * C + c] = y;
    if (c < pdim) x1[static_cast<long long>(tok) * pdim + c] = y;
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel.

using bf16 = __nv_bfloat16;

// lanes a token; tokens a block pass
constexpr int kGroup = 16;
constexpr int kGroups = kThreads / kGroup;
// channels a lane may hold: C up to kGroup * kMaxLaneChannels
constexpr int kMaxLaneChannels = 32;

// V bf16 values as one load or store
template <int V>
struct Raw;
template <>
struct Raw<4> {
  using type = uint2;
};
template <>
struct Raw<2> {
  using type = unsigned int;
};
template <>
struct Raw<1> {
  using type = unsigned short;
};

__device__ __forceinline__ float2 unpack2(unsigned int w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

__device__ __forceinline__ void unpack(uint2 r, float* f) {
  const float2 a = unpack2(r.x), b = unpack2(r.y);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}
__device__ __forceinline__ void unpack(unsigned int r, float* f) {
  const float2 a = unpack2(r);
  f[0] = a.x;
  f[1] = a.y;
}
__device__ __forceinline__ void unpack(unsigned short r, float* f) {
  f[0] = __bfloat162float(__ushort_as_bfloat16(r));
}

template <int V>
__device__ __forceinline__ typename Raw<V>::type pack(const float* f);
template <>
__device__ __forceinline__ uint2 pack<4>(const float* f) {
  return make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
}
template <>
__device__ __forceinline__ unsigned int pack<2>(const float* f) {
  return pack2(f[0], f[1]);
}
template <>
__device__ __forceinline__ unsigned short pack<1>(const float* f) {
  return __bfloat16_as_ushort(__float2bfloat16(f[0]));
}

// sum over the 16 lanes of a group; both groups of a warp take part
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A token's NV vectors of V channels into r; zeros where the token or the
// vector lies past the end.
template <int V, int NV>
__device__ __forceinline__ void load_row(typename Raw<V>::type (&r)[NV],
                                         const bf16* __restrict__ x,
                                         long long tok, bool valid, int sub,
                                         int nvec, int C) {
  using R = typename Raw<V>::type;
  const R* row = reinterpret_cast<const R*>(x + tok * C);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = sub + k * kGroup;
    r[k] = (valid && j < nvec) ? __ldg(row + j) : R{};
  }
}

template <int V, int NV>
__global__ void __launch_bounds__(kThreads)
    ln_split_vec_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta, bf16* __restrict__ ln1,
                        bf16* __restrict__ x1, int n_tok, int C, int pdim,
                        float eps) {
  using R = typename Raw<V>::type;
  const int sub = threadIdx.x & (kGroup - 1);
  const int nvec = C / V;
  const float inv_c = 1.f / C;
  const bool x1_vec = pdim % V == 0;

  // this lane's channels of gamma and beta, for every token it takes
  float g[NV][V], b[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = sub + k * kGroup;
    const bool in = j < nvec;
    unpack(in ? __ldg(reinterpret_cast<const R*>(gamma) + j) : R{}, g[k]);
    unpack(in ? __ldg(reinterpret_cast<const R*>(beta) + j) : R{}, b[k]);
  }

  // the two groups of a warp take tokens base and base + 1, so the loop's
  // condition and the shuffles stay warp-uniform
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  const long long group = static_cast<long long>(blockIdx.x) * kGroups +
                          threadIdx.x / kGroup;
  const long long first = group & ~1ll;
  const int half = static_cast<int>(group & 1);
  R cur[NV];
  load_row<V, NV>(cur, x, first + half, first + half < n_tok, sub, nvec, C);
  for (long long base = first; base < n_tok; base += stride) {
    const long long tok = base + half;
    const bool valid = tok < n_tok;
    R nxt[NV];
    load_row<V, NV>(nxt, x, tok + stride, tok + stride < n_tok, sub, nvec,
                    C);

    float v[NV][V];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      unpack(cur[k], v[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v[k][e];
    }
    const float mu = group_sum(sum) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (sub + k * kGroup < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[k][e] - mu;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum(sq) * inv_c + eps);

    if (valid) {
      R* out = reinterpret_cast<R*>(ln1 + tok * C);
      bf16* slab = x1 + tok * pdim;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = sub + k * kGroup;
        if (j < nvec) {
          float y[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            y[e] = (v[k][e] - mu) * rstd * g[k][e] + b[k][e];
          const R p = pack<V>(y);
          out[j] = p;
          if (j * V < pdim) {
            if (x1_vec) {
              reinterpret_cast<R*>(slab)[j] = p;
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e)
                if (j * V + e < pdim) slab[j * V + e] = __float2bfloat16(y[e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

template <int V, int NV>
cudaError_t launch_vec(const void* x, const void* gamma, const void* beta,
                       void* ln1, void* x1, int n_tok, int C, int pdim,
                       float eps, cudaStream_t stream) {
  // as many blocks as are resident on the card at once, no more than the
  // tokens need
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_split_vec_kernel<V, NV>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const long long need = (static_cast<long long>(n_tok) + kGroups - 1) /
                         kGroups;
  const unsigned blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  ln_split_vec_kernel<V, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(ln1),
      static_cast<bf16*>(x1), n_tok, C, pdim, eps);
  return cudaGetLastError();
}

// The smallest instance whose NV vectors a lane cover the row's nvec / 16,
// with at most kMaxLaneChannels channels a lane.
template <int V>
cudaError_t dispatch_vec(int per_lane, const void* x, const void* gamma,
                         const void* beta, void* ln1, void* x1, int n_tok,
                         int C, int pdim, float eps, cudaStream_t st) {
#define SR_LN_VEC(NV)                                                       \
  if (per_lane <= NV)                                                       \
    return launch_vec<V, NV>(x, gamma, beta, ln1, x1, n_tok, C, pdim, eps, \
                             st);
  SR_LN_VEC(1)
  SR_LN_VEC(2)
  SR_LN_VEC(3)
  SR_LN_VEC(4)
  SR_LN_VEC(6)
  SR_LN_VEC(8)
  if constexpr (V <= 2) {
    SR_LN_VEC(12)
    SR_LN_VEC(16)
  }
  if constexpr (V == 1) {
    SR_LN_VEC(24)
    SR_LN_VEC(32)
  }
#undef SR_LN_VEC
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// The float32 first version. dtype: 0 float32; 1 (bf16) is refused, bf16
// runs on sr_ln_split_vec. x and ln1 are (n_tok, C), x1 (n_tok, pdim).
// Returns the cudaError_t of the launch.
extern "C" int sr_ln_split(int dtype, const void* x, const void* gamma,
                           const void* beta, void* ln1, void* x1, int n_tok,
                           int C, int pdim, float eps, void* stream) {
  if (dtype != 0 || pdim < 0 || pdim > C || n_tok < 0)
    return cudaErrorInvalidValue;
  if (n_tok == 0) return cudaSuccess;
  const int per_block = kThreads / 32;
  const unsigned blocks = (n_tok + per_block - 1) / per_block;
  ln_split_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(ln1),
      static_cast<float*>(x1), n_tok, C, pdim, eps);
  return cudaGetLastError();
}

// The largest C the bf16 kernel takes.
extern "C" int sr_ln_split_vec_max_c() { return kGroup * kMaxLaneChannels; }

// The bf16 kernel: x, gamma, beta, ln1, x1 bf16; x and ln1 (n_tok, C), x1
// (n_tok, pdim). The vector width is the widest of 4, 2 and 1 channels that
// divides C and to whose bytes x, gamma, beta and ln1 are aligned. Refuses
// a C past sr_ln_split_vec_max_c(), a pdim outside [0, C] and a negative
// n_tok. Returns the cudaError_t of the launch.
extern "C" int sr_ln_split_vec(const void* x, const void* gamma,
                               const void* beta, void* ln1, void* x1,
                               int n_tok, int C, int pdim, float eps,
                               void* stream) {
  if (C < 1 || C > kGroup * kMaxLaneChannels || pdim < 0 || pdim > C ||
      n_tok < 0)
    return cudaErrorInvalidValue;
  if (n_tok == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto all_aligned = [&](int bytes) {
    return aligned(x, bytes) && aligned(gamma, bytes) &&
           aligned(beta, bytes) && aligned(ln1, bytes) &&
           (pdim % (bytes / 2) != 0 || aligned(x1, bytes));
  };
  auto per_lane = [&](int v) { return (C / v + kGroup - 1) / kGroup; };
  if (C % 4 == 0 && all_aligned(8))
    return dispatch_vec<4>(per_lane(4), x, gamma, beta, ln1, x1, n_tok, C,
                           pdim, eps, st);
  if (C % 2 == 0 && all_aligned(4))
    return dispatch_vec<2>(per_lane(2), x, gamma, beta, ln1, x1, n_tok, C,
                           pdim, eps, st);
  return dispatch_vec<1>(per_lane(1), x, gamma, beta, ln1, x1, n_tok, C,
                         pdim, eps, st);
}
