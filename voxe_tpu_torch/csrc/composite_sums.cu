// The colour and depth sums of the shear-warp compositing tail, forward,
// for Hopper (sm_90a).
//
// Reads the compositing kernel's weights (composite_fwd.cu; the first S of
// each slab-padded row) and, per ray r and sample i < S:
//   colour_rc = sum_i round(w_i) * y_ic,  y_ic = round(sigmoid(radiance_ic)) inside the volume, 0 outside
//   depth_r   = sum_i t_i * w_i
// where round() is the radiance dtype's rounding (bf16 or none), products
// and sums in f32: the plain tail's einsum of the weights in the radiance
// dtype against the sigmoid, and its depth sum. One warp walks one ray (8
// rays per 256-thread block), lane j taking samples j, j + 32, ...: the
// weights, depths and mask load as coalesced 128-byte rows; a lane's C
// radiance values sit 2C or 4C bytes apart, so a warp's loads of one chunk
// cover one contiguous 64C- or 128C-byte span. Each lane keeps C + 1 partial
// sums, reduced across the warp at the end. Bound: bytes (w, t, radiance
// and the mask read once a sample; colour and depth written once a ray).
// Any N >= 1, S >= 1, 1 <= C <= 6; f32 weights [N, ld] and depths [N, S],
// radiance [N, S, C] in f32 or bf16, mask [N, S] bytes, row-major.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChannels = 6;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the radiance dtype and back
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_sums_kernel(const float* __restrict__ weights, int weights_ld, const float* __restrict__ depths,
                      const T* __restrict__ radiance, const unsigned char* __restrict__ inside,
                      float* __restrict__ colour, float* __restrict__ depth, int n_rays, int n_samples,
                      int n_channels) {
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together

  const size_t row = static_cast<size_t>(ray) * static_cast<size_t>(n_samples);
  const float* w_row = weights + static_cast<size_t>(ray) * static_cast<size_t>(weights_ld);
  const float* t_row = depths + row;
  const T* r_row = radiance + row * n_channels;
  const unsigned char* m_row = inside + row;

  float col[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) col[c] = 0.0f;
  float dep = 0.0f;
  for (int i = lane; i < n_samples; i += 32) {
    const float w = w_row[i];
    dep += t_row[i] * w;
    if (m_row[i]) {
      const float w_rounded = round_to<T>(w);
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < n_channels) {
          const float r = to_float(r_row[static_cast<size_t>(i) * n_channels + c]);
          col[c] += w_rounded * round_to<T>(1.0f / (1.0f + expf(-r)));
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dep += __shfl_xor_sync(kFullMask, dep, off);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) col[c] += __shfl_xor_sync(kFullMask, col[c], off);
  }
  if (lane == 0) {
    depth[ray] = dep;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < n_channels) colour[static_cast<size_t>(ray) * n_channels + c] = col[c];
  }
}

template <typename T>
int launch(const float* weights, int weights_ld, const float* depths, const void* radiance,
           const unsigned char* inside, float* colour, float* depth, int n_rays, int n_samples, int n_channels,
           void* stream) {
  if (n_rays <= 0 || n_samples <= 0 || weights_ld < n_samples || n_channels < 1 || n_channels > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  composite_sums_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      weights, weights_ld, depths, static_cast<const T*>(radiance), inside, colour, depth, n_rays, n_samples,
      n_channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `radiance_bf16` selects the radiance dtype (1: bf16,
// 0: f32). Returns the CUDA error code of the launch (0 = ok).
extern "C" int voxe_composite_sums(const float* weights, const float* depths, const void* radiance,
                                   const unsigned char* inside, float* colour, float* depth, int weights_ld,
                                   int n_rays, int n_samples, int n_channels, int radiance_bf16, void* stream) {
  return radiance_bf16
             ? launch<__nv_bfloat16>(weights, weights_ld, depths, radiance, inside, colour, depth, n_rays,
                                     n_samples, n_channels, stream)
             : launch<float>(weights, weights_ld, depths, radiance, inside, colour, depth, n_rays, n_samples,
                             n_channels, stream);
}
