// The whole backward of the shear-warp compositing tail, for Hopper (sm_90a).
//
// Forward (composite_fwd.cu, then composite_sums.cu), per ray r over its S
// real samples, the last one's interval the slab spacing as the lane padding
// gives it (t_S = t_{S-1} + (t_{S-1} - t_{S-2})):
//   delta_k = (t_{k+1} - t_k) |dir_r|,  alpha_k = 1 - exp(-sigma_k delta_k)
//   T_k = prod_{j<k} (1 - alpha_j),  w_k = alpha_k T_k
//   colour_c = sum_k round(w_k) y_kc,  y_kc = round(sigmoid(r_kc)) inside the volume, 0 outside
//   depth = sum_k t_k w_k,  acc = sum_k w_k
// round() is the radiance dtype's rounding (bf16 or none). Given g_colour
// [N, C], g_depth [N] and g_acc [N], with
//   e_k = round(sum_c g_c y_kc) + g_depth t_k + g_acc
// (the plain tail's gradient of w_k: the colour sum's part reaches the f32
// weights through the cast to the radiance dtype, so it is rounded there):
//   dsigma_k = delta_k (T_{k+1} e_k - G_k),  G_k = sum_{i>k} e_i w_i
//   dr_kc = round(round(gy_kc round(1 - y_kc)) y_kc) inside, 0 outside,  gy_kc = round(round(w_k) g_c)
// (dr: the plain tail's cast of the colour's f32 gradient to the radiance
// dtype, then the sigmoid's backward as the library computes it on the
// card, each step in the radiance dtype).
//
// One warp walks one ray in chunks of 32 samples, recomputing T and w with
// composite_fwd.cu's arithmetic (the same shuffle product scan over the same
// chunks, so w is the forward's bit for bit). dr is written in that sweep.
// G_k is a suffix sum: the sweep leaves e_k w_k, T_{k+1} e_k and delta_k of
// every sample in shared memory, and a second sweep from the ray's end down
// carries G exactly (a shuffle suffix scan within a chunk, the later chunks'
// total carried in), so an opaque ray's G is the sum of its tiny tail terms
// and not a difference of two totals. Skipped, with its shared memory, when
// dsigma is not wanted (dsigma null); dr is skipped when dradiance is null.
// Bound: bytes (sigma, depths, radiance and the mask read once a sample,
// dsigma and dr written once; the [N] vectors once a ray). Any N >= 1,
// S >= 2, 1 <= C <= 6; f32 sigma and depths [N, S], radiance [N, S, C] in
// f32 or bf16, mask [N, S] bytes, f32 g_colour [N, C], g_depth and g_acc
// [N], row-major; dsigma f32, dradiance in the radiance dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxChannels = 6;
constexpr int kSharedBudget = 48 * 1024;  // bytes a block takes without opting in
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

template <typename T>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
composite_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ depths,
                     const float* __restrict__ dir_norms, const T* __restrict__ radiance,
                     const unsigned char* __restrict__ inside, const float* __restrict__ g_colour,
                     const float* __restrict__ g_depth, const float* __restrict__ g_acc,
                     float* __restrict__ dsigma, T* __restrict__ dradiance, int n_rays, int n_samples,
                     int n_channels) {
  extern __shared__ float shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (ray >= n_rays) return;  // the whole warp leaves together

  const size_t row = static_cast<size_t>(ray) * static_cast<size_t>(n_samples);
  const float* s_row = sigma + row;
  const float* d_row = depths + row;
  const T* r_row = radiance + row * n_channels;
  const unsigned char* m_row = inside + row;
  const float dir_norm = dir_norms[ray];
  const float gd = g_depth[ray];
  const float ga = g_acc[ray];
  float gc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) gc[c] = c < n_channels ? g_colour[ray * n_channels + c] : 0.0f;

  const bool want_sigma = dsigma != nullptr;
  const int padded = (n_samples + 31) & ~31;
  float* ew_s = shared + static_cast<size_t>(warp) * 3 * padded;  // e_k w_k
  float* te_s = ew_s + padded;                                     // T_{k+1} e_k
  float* dl_s = te_s + padded;                                     // delta_k

  float carried = 1.0f;  // transmittance in front of the current chunk
  float d = lane < n_samples ? d_row[lane] : 0.0f;
  for (int c0 = 0; c0 < n_samples; c0 += 32) {
    const int i = c0 + lane;
    const bool valid = i < n_samples;
    const float s = valid ? s_row[i] : 0.0f;
    const float d_following = i + 32 < n_samples ? d_row[i + 32] : 0.0f;

    float d_next = __shfl_down_sync(kFullMask, d, 1);
    const float next_chunk_first = __shfl_sync(kFullMask, d_following, 0);
    if (lane == 31) d_next = next_chunk_first;
    if (i == n_samples - 1) {  // the first padding depth: the last spacing repeated
      const float spacing = d - d_row[n_samples - 2];
      d_next = d + spacing;
    }
    const float delta = (d_next - d) * dir_norm;
    const float alpha = valid ? 1.0f - expf(-(s * delta)) : 0.0f;

    float incl = 1.0f - alpha;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) excl = 1.0f;

    const float w = alpha * (carried * excl);  // composite_fwd.cu's weight, bit for bit
    const float t_next = carried * incl;       // T_{k+1}

    float ec = 0.0f;
    if (valid && m_row[i]) {
      const float w_rounded = round_to<T>(w);
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < n_channels) {
          const size_t at = static_cast<size_t>(i) * n_channels + c;
          const float y = round_to<T>(1.0f / (1.0f + expf(-to_float(r_row[at]))));
          ec += gc[c] * y;
          if (dradiance != nullptr) {
            const float gy = round_to<T>(w_rounded * gc[c]);
            dradiance[row * n_channels + at] = from_float<T>(round_to<T>(gy * round_to<T>(1.0f - y)) * y);
          }
        }
      }
    } else if (valid && dradiance != nullptr) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < n_channels) dradiance[(row + i) * n_channels + c] = from_float<T>(0.0f);
    }
    if (want_sigma && valid) {
      const float e = round_to<T>(ec) + gd * d + ga;
      ew_s[i] = e * w;
      te_s[i] = t_next * e;
      dl_s[i] = delta;
    }
    carried *= __shfl_sync(kFullMask, incl, 31);
    d = d_following;
  }
  if (!want_sigma) return;
  __syncwarp();

  float later = 0.0f;  // sum of e_i w_i over the chunks after the current one
  float* ds_row = dsigma + row;
  for (int c0 = padded - 32; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    const bool valid = i < n_samples;
    const float q = valid ? ew_s[i] : 0.0f;
    float suffix = q;  // inclusive suffix sum within the chunk
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(kFullMask, suffix, off);
      if (lane + off < 32) suffix += v;
    }
    float after = __shfl_down_sync(kFullMask, suffix, 1);
    if (lane == 31) after = 0.0f;
    if (valid) ds_row[i] = dl_s[i] * (te_s[i] - (later + after));
    later += __shfl_sync(kFullMask, suffix, 0);
  }
}

template <typename T>
int launch(const float* sigma, const float* depths, const float* dir_norms, const void* radiance,
           const unsigned char* inside, const float* g_colour, const float* g_depth, const float* g_acc,
           float* dsigma, void* dradiance, int n_rays, int n_samples, int n_channels, void* stream) {
  if (n_rays <= 0 || n_samples < 2 || n_channels < 1 || n_channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  // without dsigma no shared memory; with it 12 bytes a sample a warp, as
  // many warps a block as fit the default budget (8 up to S = 512), then
  // one warp a block, opting in above the budget
  const size_t per_warp = dsigma != nullptr ? 12u * static_cast<size_t>((n_samples + 31) & ~31) : 0u;
  int warps = kMaxWarpsPerBlock;
  if (per_warp > 0) {
    const size_t fit = kSharedBudget / per_warp;
    warps = static_cast<int>(fit < 1 ? 1 : (fit > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : fit));
  }
  const size_t shared = per_warp * warps;
  if (shared > kSharedBudget) {
    const cudaError_t err =
        cudaFuncSetAttribute(composite_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n_rays + warps - 1) / warps);
  composite_bwd_kernel<T><<<blocks, warps * 32, shared, static_cast<cudaStream_t>(stream)>>>(
      sigma, depths, dir_norms, static_cast<const T*>(radiance), inside, g_colour, g_depth, g_acc, dsigma,
      static_cast<T*>(dradiance), n_rays, n_samples, n_channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `radiance_bf16` selects the radiance dtype (1: bf16,
// 0: f32); a null `dsigma` or `dradiance` is not computed. Returns the CUDA
// error code of the launch (0 = ok).
extern "C" int voxe_composite_bwd(const float* sigma, const float* depths, const float* dir_norms,
                                  const void* radiance, const unsigned char* inside, const float* g_colour,
                                  const float* g_depth, const float* g_acc, float* dsigma, void* dradiance,
                                  int n_rays, int n_samples, int n_channels, int radiance_bf16, void* stream) {
  return radiance_bf16
             ? launch<__nv_bfloat16>(sigma, depths, dir_norms, radiance, inside, g_colour, g_depth, g_acc, dsigma,
                                     dradiance, n_rays, n_samples, n_channels, stream)
             : launch<float>(sigma, depths, dir_norms, radiance, inside, g_colour, g_depth, g_acc, dsigma,
                             dradiance, n_rays, n_samples, n_channels, stream);
}
