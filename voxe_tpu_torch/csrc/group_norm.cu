// GroupNorm with an optional SiLU after it, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's ReduceFirstGroupNorm
// (voxe_tpu/models/sd/norms.py) is plain jnp that XLA fuses into a few
// passes; eager PyTorch runs the same formula as some twenty launches, with
// an f32 copy of the activation that autograd keeps, about 48 bytes an
// element forward with the SiLU after it and 70-90 backward. This kernel
// computes the same statistics (per-channel sums of x and x^2 in f32, folded
// to group moments, var = max(E[x^2] - E[x]^2, 0), a = rstd * gamma,
// b = beta - mean * a) and moves about 6 bytes an element forward (x read
// twice, y written once, bf16) and 10 backward (x and dy read twice, dx
// written once).
//
// Bound: bytes. Each direction is three launches on one stream:
//   1. a pass over the tensor that writes per-channel partial sums over one
//      split of the pixels to a [2, S, B, C] f32 workspace: (x, x^2) forward,
//      (g, g * x) backward, with g = dy * silu'(x * a + b) (or dy);
//   2. a fold, one block a group, that sums the workspace in a fixed order:
//      forward a, b [B, C] and (mean, rstd, E[x^2] - mean^2) [B, G];
//      backward dgamma, dbeta [C] and two coefficients a (b, group) [B, G, 2]
//      of dx = g * a + c1 + c2 * x, the exact derivative of the formula above
//      (the clamp passes no gradient where E[x^2] - mean^2 < 0);
//   3. an elementwise pass that writes y = x * a + b (then SiLU) or dx.
// No float atomics: every sum runs in an order fixed by the shape, so a call
// is bitwise repeatable and a CUDA graph's replay equals the eager call.
// Nothing allocates or synchronises here; the caller's stream orders it all.
//
// Layouts: channels_last (NHWC in memory) and contiguous NCHW, 4-D, bf16 or
// f32 activations, bf16 or f32 gamma/beta. NHWC: a block is tc channel
// vectors x tp pixel lanes, each thread holding one vector's coefficients in
// registers and walking its pixels, so every warp's loads are contiguous
// 16-byte vectors over C. NCHW: one warp a (b, c) row. The caller chooses
// the number of splits S from the shape so that the grid fills the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;   // a block of the pass kernels (NHWC: tc * tp of them)
constexpr int kFoldThreads = 256;  // a block of the folds; a power of two
constexpr int kRowsPerBlock = 8;   // NCHW: one warp a (b, c) row
constexpr int kUnroll = 4;         // vectors a thread loads before it uses them
constexpr unsigned kFullMask = 0xffffffffu;

enum Pass : int { kStatsFwd = 0, kApplyFwd = 1, kStatsBwd = 2, kApplyBwd = 3 };

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements loaded or stored as one access (16 bytes when V * sizeof(T) == 16).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct PassArgs {
  const void* x;
  const void* dy;
  void* out;           // y (forward) or dx (backward)
  const float* a;      // [B, C]
  const float* b;      // [B, C]
  const float* coef;   // [B, G, 2]: c1, c2 of dx
  float* partial;      // [2, S, B, C]
  int B, C, HW, G, S, tc, silu;
};

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// One element of a pass. The affine step rounds the product and the sum
// apart, as the plain version's two passes do; SiLU and its derivative are
// PyTorch's formulas.
template <int PASS>
__device__ __forceinline__ float element(float x, float dy, float a, float b, float c1, float c2, bool silu,
                                         float& acc1, float& acc2) {
  if constexpr (PASS == kStatsFwd) {
    acc1 += x;
    acc2 += x * x;
    return 0.0f;
  } else {
    const float z = __fadd_rn(__fmul_rn(x, a), b);
    if constexpr (PASS == kApplyFwd) {
      return silu ? z / (1.0f + expf(-z)) : z;
    } else {
      float g = dy;
      if (silu) {
        const float s = sigmoid(z);
        g = dy * (s * (1.0f + z * (1.0f - s)));
      }
      if constexpr (PASS == kStatsBwd) {
        acc1 += g;
        acc2 += g * x;
        return 0.0f;
      } else {
        return g * a + c1 + c2 * x;
      }
    }
  }
}

template <int PASS, typename T, int V>
__device__ __forceinline__ void visit(const Pack<T, V>& px, const Pack<T, V>& pd, const float (&a)[V],
                                      const float (&b)[V], const float (&c1)[V], const float (&c2)[V], bool silu,
                                      float (&acc1)[V], float (&acc2)[V], T* out) {
  Pack<T, V> po;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float dy = 0.0f;
    if constexpr (PASS >= kStatsBwd) dy = to_float(pd.v[i]);
    const float o = element<PASS>(to_float(px.v[i]), dy, a[i], b[i], c1[i], c2[i], silu, acc1[i], acc2[i]);
    if constexpr (PASS == kApplyFwd || PASS == kApplyBwd) po.v[i] = from_float<T>(o);
  }
  if constexpr (PASS == kApplyFwd || PASS == kApplyBwd) *reinterpret_cast<Pack<T, V>*>(out) = po;
}

template <int PASS, typename T, int V>
__device__ __forceinline__ void load(const T* x, const T* dy, long long off, Pack<T, V>& px, Pack<T, V>& pd) {
  px = *reinterpret_cast<const Pack<T, V>*>(x + off);
  if constexpr (PASS >= kStatsBwd) pd = *reinterpret_cast<const Pack<T, V>*>(dy + off);
}

// The coefficients of channel c of batch row bi.
template <int PASS>
__device__ __forceinline__ void coefficients(const PassArgs& p, int bi, int c, float& a, float& b, float& c1,
                                             float& c2) {
  a = b = c1 = c2 = 0.0f;
  if constexpr (PASS != kStatsFwd) {
    a = p.a[bi * p.C + c];
    b = p.b[bi * p.C + c];
  }
  if constexpr (PASS == kApplyBwd) {
    const int k = (bi * p.G + c / (p.C / p.G)) * 2;
    c1 = p.coef[k];
    c2 = p.coef[k + 1];
  }
}

// NHWC: block (split s, channel chunk, batch row bi); thread (lane_c, lane_p)
// holds channel vector blockIdx.y * tc + lane_c and walks pixels lane_p,
// lane_p + tp, ... of the split.
template <typename T, int V, int PASS>
__global__ void __launch_bounds__(kMaxThreads) group_norm_nhwc_kernel(PassArgs p) {
  constexpr bool kStats = PASS == kStatsFwd || PASS == kStatsBwd;
  __shared__ float red[kStats ? 2 * kMaxThreads * V : 1];
  const int tc = p.tc, tp = blockDim.x / tc;
  const int lane_c = threadIdx.x % tc, lane_p = threadIdx.x / tc;
  const int cv = blockIdx.y * tc + lane_c;
  const bool active = cv < p.C / V;
  const int bi = blockIdx.z, s = blockIdx.x;
  const int seg = (p.HW + p.S - 1) / p.S;
  const int p0 = s * seg, p1 = min(p.HW, p0 + seg);
  const int c0 = cv * V;

  float a[V], b[V], c1[V], c2[V], acc1[V], acc2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc1[i] = acc2[i] = 0.0f;
    if (active) coefficients<PASS>(p, bi, c0 + i, a[i], b[i], c1[i], c2[i]);
  }
  if (active) {
    const long long base = static_cast<long long>(bi) * p.HW * p.C + c0;
    const T* x = static_cast<const T*>(p.x) + base;
    const T* dy = static_cast<const T*>(p.dy) + base;
    T* out = static_cast<T*>(p.out) + base;
    const long long C = p.C;
    int q = p0 + lane_p;
    for (; q + (kUnroll - 1) * tp < p1; q += kUnroll * tp) {
      Pack<T, V> px[kUnroll], pd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<PASS>(x, dy, (q + u * tp) * C, px[u], pd[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        visit<PASS>(px[u], pd[u], a, b, c1, c2, p.silu, acc1, acc2, out + (q + u * tp) * C);
    }
    for (; q < p1; q += tp) {
      Pack<T, V> px, pd;
      load<PASS>(x, dy, q * C, px, pd);
      visit<PASS>(px, pd, a, b, c1, c2, p.silu, acc1, acc2, out + q * C);
    }
  }
  if constexpr (kStats) {
    // the tp pixel lanes of each channel vector, summed in lane order
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[threadIdx.x * V + i] = acc1[i];
      red[(kMaxThreads + threadIdx.x) * V + i] = acc2[i];
    }
    __syncthreads();
    if (lane_p == 0 && active) {
      const long long plane = static_cast<long long>(p.S) * p.B * p.C;
      const long long o = (static_cast<long long>(s) * p.B + bi) * p.C + c0;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t1 = 0.0f, t2 = 0.0f;
        for (int k = 0; k < tp; ++k) {
          t1 += red[(k * tc + lane_c) * V + i];
          t2 += red[(kMaxThreads + k * tc + lane_c) * V + i];
        }
        p.partial[o + i] = t1;
        p.partial[plane + o + i] = t2;
      }
    }
  }
}

// NCHW: block (split s, 8 rows); warp w holds row blockIdx.y * 8 + w of the
// [B * C, HW] matrix and walks its split in vectors of V pixels.
template <typename T, int V, int PASS>
__global__ void __launch_bounds__(kRowsPerBlock * 32) group_norm_nchw_kernel(PassArgs p) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.y) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.B) * p.C) return;  // the whole warp leaves together
  const int bi = static_cast<int>(row / p.C), c = static_cast<int>(row % p.C), s = blockIdx.x;
  int seg = (p.HW + p.S - 1) / p.S;
  seg = (seg + V - 1) / V * V;  // a vector never straddles two splits
  const int p0 = s * seg, p1 = min(p.HW, p0 + seg);

  float a[V], b[V], c1[V], c2[V], acc1[V], acc2[V];
  float a0, b0, c10, c20;
  coefficients<PASS>(p, bi, c, a0, b0, c10, c20);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = a0, b[i] = b0, c1[i] = c10, c2[i] = c20;
    acc1[i] = acc2[i] = 0.0f;
  }
  const long long base = row * p.HW;
  const T* x = static_cast<const T*>(p.x) + base;
  const T* dy = static_cast<const T*>(p.dy) + base;
  T* out = static_cast<T*>(p.out) + base;
  constexpr int kStep = 32 * V;
  int q = p0 + lane * V;
  for (; q + (kUnroll - 1) * kStep < p1; q += kUnroll * kStep) {
    Pack<T, V> px[kUnroll], pd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<PASS>(x, dy, q + u * kStep, px[u], pd[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      visit<PASS>(px[u], pd[u], a, b, c1, c2, p.silu, acc1, acc2, out + q + u * kStep);
  }
  for (; q < p1; q += kStep) {
    Pack<T, V> px, pd;
    load<PASS>(x, dy, q, px, pd);
    visit<PASS>(px, pd, a, b, c1, c2, p.silu, acc1, acc2, out + q);
  }
  if constexpr (PASS == kStatsFwd || PASS == kStatsBwd) {
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) t1 += acc1[i], t2 += acc2[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(kFullMask, t1, off);
      t2 += __shfl_xor_sync(kFullMask, t2, off);
    }
    if (lane == 0) {
      const long long o = static_cast<long long>(s) * p.B * p.C + row;
      p.partial[o] = t1;
      p.partial[static_cast<long long>(p.S) * p.B * p.C + o] = t2;
    }
  }
}

// A fixed tree over the block; the sums end in red[.][0].
__device__ __forceinline__ void block_sum2(float v1, float v2, float (&red)[2][kFoldThreads]) {
  const int t = threadIdx.x;
  red[0][t] = v1;
  red[1][t] = v2;
  __syncthreads();
  for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[0][t] += red[0][t + h];
      red[1][t] += red[1][t + h];
    }
    __syncthreads();
  }
}

// Forward fold, block g: the group's moments from the workspace, then
// a = rstd * gamma, b = beta - mean * a for its channels, and
// stats[b, g] = (mean, rstd, E[x^2] - mean^2).
template <typename P>
__global__ void __launch_bounds__(kFoldThreads)
group_norm_fold_fwd_kernel(const float* __restrict__ partial, const P* __restrict__ gamma,
                           const P* __restrict__ beta, float* __restrict__ a, float* __restrict__ b,
                           float* __restrict__ stats, int B, int C, int G, int S, float n, float eps) {
  __shared__ float red[2][kFoldThreads];
  const int g = blockIdx.x, reps = C / G, t = threadIdx.x;
  const long long plane = static_cast<long long>(S) * B * C;
  for (int bi = 0; bi < B; ++bi) {
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll 4
    for (int i = t; i < S * reps; i += kFoldThreads) {
      const int s = i / reps, j = i - s * reps;
      const long long o = (static_cast<long long>(s) * B + bi) * C + g * reps + j;
      t1 += partial[o];
      t2 += partial[plane + o];
    }
    block_sum2(t1, t2, red);
    const float mean = red[0][0] / n, ex2 = red[1][0] / n;
    const float d = __fsub_rn(ex2, __fmul_rn(mean, mean));
    const float var = d < 0.0f ? 0.0f : d;  // NaN stays NaN, as the plain clamp keeps it
    const float rstd = 1.0f / sqrtf(var + eps);
    for (int j = t; j < reps; j += kFoldThreads) {
      const int c = g * reps + j;
      const float ac = __fmul_rn(rstd, to_float(gamma[c]));
      a[bi * C + c] = ac;
      b[bi * C + c] = __fsub_rn(to_float(beta[c]), __fmul_rn(mean, ac));
    }
    if (t == 0) {
      float* st = stats + (bi * G + g) * 3;
      st[0] = mean, st[1] = rstd, st[2] = d;
    }
    __syncthreads();  // red is reused by the next row
  }
}

// Backward fold, block g (C / G <= kFoldThreads): thread (j, lane) sums
// splits lane, lane + lanes, ... of channel j's (g, g * x) totals; lane 0
// adds the lanes in order, then the group's terms go through a fixed tree.
// With da_c = sum(g x) - mean * sum(g) (the gradient of a_c after b's share):
//   dgamma_c = sum_b rstd * da_c,  dbeta_c = sum_b sum(g),
//   drstd = sum_c gamma_c da_c,  dvar = -rstd^3 / 2 * drstd where the
//   unclamped variance is >= 0, else 0,
//   dmean = -sum_c a_c sum(g) - 2 mean dvar,
//   dx = g * a + dmean / n + (2 dvar / n) * x.
template <typename P>
__global__ void __launch_bounds__(kFoldThreads)
group_norm_fold_bwd_kernel(const float* __restrict__ partial, const P* __restrict__ gamma,
                           const float* __restrict__ a, const float* __restrict__ stats, float* __restrict__ coef,
                           P* __restrict__ dgamma, P* __restrict__ dbeta, int B, int C, int G, int S, float n) {
  __shared__ float red[2][kFoldThreads];
  const int g = blockIdx.x, reps = C / G, t = threadIdx.x;
  const int lanes = kFoldThreads / reps;
  const int j = t % reps, lane = t / reps, c = g * reps + j;
  const long long plane = static_cast<long long>(S) * B * C;
  const float gam = to_float(gamma[c]);
  float dgam = 0.0f, dbet = 0.0f;
  for (int bi = 0; bi < B; ++bi) {
    float s1 = 0.0f, s2 = 0.0f;
    if (lane < lanes) {
#pragma unroll 4
      for (int s = lane; s < S; s += lanes) {
        const long long o = (static_cast<long long>(s) * B + bi) * C + c;
        s1 += partial[o];
        s2 += partial[plane + o];
      }
    }
    red[0][t] = s1;
    red[1][t] = s2;
    __syncthreads();
    const float* st = stats + (bi * G + g) * 3;
    const float mean = st[0], rstd = st[1], d = st[2];
    float e1 = 0.0f, e2 = 0.0f;
    if (lane == 0) {
      float g1 = 0.0f, g2 = 0.0f;
      for (int k = 0; k < lanes; ++k) {
        g1 += red[0][k * reps + j];
        g2 += red[1][k * reps + j];
      }
      const float da = __fsub_rn(g2, __fmul_rn(mean, g1));
      dgam += rstd * da;
      dbet += g1;
      e1 = gam * da;
      e2 = a[bi * C + c] * g1;
    }
    __syncthreads();
    block_sum2(e1, e2, red);
    if (t == 0) {
      const float dvar = d >= 0.0f ? -0.5f * red[0][0] * (rstd * rstd * rstd) : 0.0f;
      const float dmean = -red[1][0] - 2.0f * mean * dvar;
      coef[(bi * G + g) * 2] = dmean / n;
      coef[(bi * G + g) * 2 + 1] = 2.0f * dvar / n;
    }
    __syncthreads();
  }
  if (lane == 0) {
    dgamma[c] = from_float<P>(dgam);
    dbeta[c] = from_float<P>(dbet);
  }
}

template <typename T, int V, int PASS>
cudaError_t launch_pass(const PassArgs& p, int nhwc, int tp, cudaStream_t stream) {
  if (nhwc) {
    const int chunks = (p.C / V + p.tc - 1) / p.tc;
    group_norm_nhwc_kernel<T, V, PASS><<<dim3(p.S, chunks, p.B), p.tc * tp, 0, stream>>>(p);
  } else {
    const unsigned rows = static_cast<unsigned>((static_cast<long long>(p.B) * p.C + kRowsPerBlock - 1) / kRowsPerBlock);
    group_norm_nchw_kernel<T, V, PASS><<<dim3(p.S, rows), kRowsPerBlock * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int PASS>
cudaError_t pass(const PassArgs& p, int nhwc, int tp, int dtype, int vec, cudaStream_t stream) {
  if (dtype == 1) {
    return vec > 1 ? launch_pass<__nv_bfloat16, 8, PASS>(p, nhwc, tp, stream)
                   : launch_pass<__nv_bfloat16, 1, PASS>(p, nhwc, tp, stream);
  }
  return vec > 1 ? launch_pass<float, 4, PASS>(p, nhwc, tp, stream) : launch_pass<float, 1, PASS>(p, nhwc, tp, stream);
}

// What the launches take; cudaErrorInvalidValue otherwise. dtype and pdtype:
// 0 float32, 1 bfloat16; vec is 16 / sizeof(element) or 1.
bool valid(int B, int C, int HW, int G, int S, int tc, int tp, int nhwc, int dtype, int pdtype, int vec) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || S <= 0 || C % G != 0 || C / G > kFoldThreads) return false;
  if ((dtype != 0 && dtype != 1) || (pdtype != 0 && pdtype != 1)) return false;
  if (vec != 1 && vec != (dtype == 1 ? 8 : 4)) return false;
  if (B > 65535) return false;
  if (nhwc) {
    if (C % vec != 0 || tc <= 0 || tp <= 0 || tc * tp > kMaxThreads) return false;
    if ((C / vec + tc - 1) / tc > 65535) return false;
  } else {
    if (HW % vec != 0 || (static_cast<long long>(B) * C + kRowsPerBlock - 1) / kRowsPerBlock > 65535) return false;
  }
  return true;
}

}  // namespace

// Forward: y = x * a + b (then SiLU when silu != 0), three launches on
// `stream`. aux (f32) receives a [B, C], b [B, C] and stats [B, G, 3] in that
// order; partial is the [2, S, B, C] f32 workspace. Returns the first CUDA
// error of the launches (0 = ok).
extern "C" int voxe_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y, float* aux,
                                   float* partial, int B, int C, int HW, int G, int S, int tc, int tp, int nhwc,
                                   int dtype, int pdtype, int vec, int silu, float eps, void* stream) {
  if (!valid(B, C, HW, G, S, tc, tp, nhwc, dtype, pdtype, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = aux;
  float* b = aux + static_cast<long long>(B) * C;
  float* stats = aux + 2 * static_cast<long long>(B) * C;
  const PassArgs p{x, x, y, a, b, nullptr, partial, B, C, HW, G, S, tc, silu};
  cudaError_t err = pass<kStatsFwd>(p, nhwc, tp, dtype, vec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float n = static_cast<float>(static_cast<long long>(C / G) * HW);
  if (pdtype == 1) {
    group_norm_fold_fwd_kernel<__nv_bfloat16><<<G, kFoldThreads, 0, st>>>(
        partial, static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(beta), a, b, stats, B,
        C, G, S, n, eps);
  } else {
    group_norm_fold_fwd_kernel<float><<<G, kFoldThreads, 0, st>>>(
        partial, static_cast<const float*>(gamma), static_cast<const float*>(beta), a, b, stats, B, C, G, S, n, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(pass<kApplyFwd>(p, nhwc, tp, dtype, vec, st));
}

// Backward at the upstream gradient dy (x's dtype and layout): dx (x's),
// dgamma and dbeta (gamma's dtype), three launches on `stream`. aux is the
// forward's; scratch (f32) holds coef [B, G, 2] then the [2, S, B, C]
// workspace.
extern "C" int voxe_group_norm_bwd(const void* x, const void* dy, const void* gamma, const float* aux, void* dx,
                                   void* dgamma, void* dbeta, float* scratch, int B, int C, int HW, int G, int S,
                                   int tc, int tp, int nhwc, int dtype, int pdtype, int vec, int silu, void* stream) {
  if (!valid(B, C, HW, G, S, tc, tp, nhwc, dtype, pdtype, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = aux;
  const float* b = aux + static_cast<long long>(B) * C;
  const float* stats = aux + 2 * static_cast<long long>(B) * C;
  float* coef = scratch;
  float* partial = scratch + 2 * static_cast<long long>(B) * G;
  const PassArgs p{x, dy, dx, a, b, coef, partial, B, C, HW, G, S, tc, silu};
  cudaError_t err = pass<kStatsBwd>(p, nhwc, tp, dtype, vec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float n = static_cast<float>(static_cast<long long>(C / G) * HW);
  if (pdtype == 1) {
    group_norm_fold_bwd_kernel<__nv_bfloat16><<<G, kFoldThreads, 0, st>>>(
        partial, static_cast<const __nv_bfloat16*>(gamma), a, stats, coef, static_cast<__nv_bfloat16*>(dgamma),
        static_cast<__nv_bfloat16*>(dbeta), B, C, G, S, n);
  } else {
    group_norm_fold_bwd_kernel<float><<<G, kFoldThreads, 0, st>>>(
        partial, static_cast<const float*>(gamma), a, stats, coef, static_cast<float*>(dgamma),
        static_cast<float*>(dbeta), B, C, G, S, n);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(pass<kApplyBwd>(p, nhwc, tp, dtype, vec, st));
}
