// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 in / f32 accumulate
// / bf16 out, non-causal and unmasked: O = softmax(Q K^T * scale) V.
//
// Replaces: the Pallas TPU kernel that voxe_tpu's UNet self-attention calls,
// voxe_tpu/models/sd/unet.py:156-171 (JAX's library
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, forward;
// gate unet.py:57-80). Wrapper: voxe_tpu_torch/ops/flash_attention.py.
//
// Bound at the main shape, SD 2.x's 64x64 level, B=2 (CFG), h=5, Q=K=4096,
// d=64: 4*B*h*Q*K*d = 42.9 GFLOP, about 43 us at 989 TFLOP/s bf16; q/k/v/o
// are 4 x 5.24 MB = 21.0 MB, about 6.3 us at 3.35 TB/s. So it is compute-bound: the
// design keeps the [Q, K] scores out of device memory and feeds the tensor
// cores.
//
// Design (a simple, correct first version; wgmma/TMA come later):
//  * layout [B, L, h, d] (row stride h*d), so the UNet needs no transposes;
//  * one block of 4 warps per (tile of 64 query rows, head, batch); each
//    warp owns 16 query rows and keeps its Q fragments in registers;
//  * K/V tiles of 64 keys stream through shared memory; K row-major, V
//    stored transposed so both products read 32-bit B fragments;
//  * S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16, f32 accumulate);
//    the S accumulator layout is reused as the A fragment of P;
//  * online softmax in f32 with a running max and sum per row, in base 2
//    with scale*log2(e) folded into the scores;
//  * a ragged last key tile is masked to -inf, ragged query rows are read
//    as zeros and not stored. Head dims 64 and 128 only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block (4 warps x 16)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                     int Lq, int Lk, float scale_log2) {
  constexpr int KS = D + 8;        // K row stride in smem (bf16): conflict-free fragment reads
  constexpr int VS = kBlockN + 8;  // V^T row stride
  constexpr int VEC = 8;           // bf16 per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int h = blockIdx.y, b = blockIdx.z;
  const long stride = (long)H * D;  // elements between consecutive sequence rows
  const __nv_bfloat16* qb = q + ((long)b * Lq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Lk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long)b * Lk * H + h) * D;
  __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * D;

  const int r0 = blockIdx.x * kBlockM + warp * 16 + g;  // rows r0 and r0 + 8
  const int r1 = r0 + 8;
  const bool ok0 = r0 < Lq, ok1 = r1 < Lq;

  // Q as A fragments, one set of 4 registers per 16-wide slice of d
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t * 2;
    qf[kc][0] = ok0 ? ld32(qb + r0 * stride + c) : 0u;
    qf[kc][1] = ok1 ? ld32(qb + r1 * stride + c) : 0u;
    qf[kc][2] = ok0 ? ld32(qb + r0 * stride + c + 8) : 0u;
    qf[kc][3] = ok1 ? ld32(qb + r1 * stride + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (base-2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int n0 = 0; n0 < Lk; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockN * D / VEC; i += kThreads) {
      const int kr = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (n0 + kr < Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long)(n0 + kr) * stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long)(n0 + kr) * stride + c);
      }
      *reinterpret_cast<uint4*>(&k_s[kr * KS + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vt_s[(c + j) * VS + kr] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &k_s[(nt * 8 + g) * KS + t * 2];
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) mma_16816(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // scale, mask the ragged tail, row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const int col = n0 + nt * 8 + t * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = (col + (e & 1) < Lk) ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds at least one valid key, so mx0/mx1 are finite here
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O += P V: two adjacent S tiles form one 16-key A fragment
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vt_s[(dt * 8 + g) * VS + kc * 16 + t * 2];
        mma_16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * stride + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * stride + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

}  // namespace

// q, o: [B, Lq, H, D]; k, v: [B, Lk, H, D]; all bf16, contiguous, 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int voxe_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Lq, int Lk, int D, float scale, void* stream) {
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, H, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, H, Lq, Lk, scale_log2);
  } else if (D == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, H, Lq, Lk, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
