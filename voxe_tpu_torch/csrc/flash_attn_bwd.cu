// Flash-attention backward for NVIDIA Hopper (sm_90a), bf16 in / f32
// accumulate / bf16 out, non-causal and unmasked. Given the forward's inputs
// q, k, v, its row log-sum-exp lse (written by csrc/flash_attn_fwd.cu) and
// Di = rowsum(dO * O) (computed by the wrapper), with S = Q K^T * scale:
//   P  = exp(S - lse)
//   dV = P^T dO
//   dS = P * (dO V^T - Di)
//   dK = dS^T Q * scale
//   dQ = dS K * scale
// without forming the [B, h, Lq, Lk] scores in device memory.
//
// Replaces: the custom VJP of JAX's library Pallas flash attention that
// voxe_tpu's UNet self-attention calls (voxe_tpu/models/sd/unet.py:156-171):
// `_flash_attention_bwd` in jax/experimental/pallas/ops/tpu/flash_attention.py,
// over its two kernels `_flash_attention_dkv_kernel` (pallas_call at :1121)
// and `_flash_attention_dq_kernel` (pallas_call at :1456). Wrapper:
// voxe_tpu_torch/ops/flash_attention.py (flash_attention_backward, and the
// autograd function around the forward).
//
// What bounds it, at the main shape (SD 2.x's 64x64 level, B=2, h=5,
// L=4096, d=64): the five products above are 2*B*h*L*L*d flops each, 107.4
// GFLOP, 0.109 ms at 989 TFLOP/s bf16; the bytes (q, k, v, o, dO read, dq,
// dk, dv written, lse and Di) are about 42 MB, 0.0125 ms at 3.35 TB/s. So it
// is bound by the tensor cores.
//
// Design (FlashAttention-2's split; a simple, correct first version with
// mma.sync m16n8k16 bf16 tensor-core products and f32 accumulators; wgmma,
// TMA and warp specialisation are later work):
//  * dK/dV kernel: one block of 4 warps per (64 keys, head, batch). The K and
//    V tile stays in shared memory; each warp owns 16 keys and keeps their
//    dK and dV in registers while the block walks over every query tile.
//    It computes S^T = K Q^T and dP^T = V dO^T directly in the transposed
//    orientation, so P^T and dS^T come out in the accumulator layout that
//    is also the A operand of dV += P^T dO and dK += dS^T Q. Each block owns
//    its keys: no atomics, deterministic sums.
//  * dQ kernel: one block of 4 warps per (64 queries, head, batch); each warp
//    owns 16 queries with their Q and dO fragments, lse and Di in registers,
//    walks over every key tile, recomputes S and dP, and accumulates
//    dQ += dS K in registers.
//  * both recompute S (2 of the 7 products are recomputation, so the work is
//    7/5 of the bound's); the exponent is exp2(S * scale * log2(e) - lse *
//    log2(e)) in f32; P and dS are rounded to bf16 only as mma operands.
//  * shared-memory tiles are padded by 8 bf16 a row, so the fragment reads
//    (8 rows x 4 words a warp) hit 32 distinct banks; a tile that a product
//    reads transposed (Q and dO in dK/dV, K in dQ) is stored a second time
//    transposed on its way in.
//  * ragged lengths: rows past Lq or Lk load as zeros; a query past Lq gets
//    lse = +inf (P = 0) in the dK/dV kernel, a key past Lk gets P = 0 in the
//    dQ kernel, and neither is stored.
// Query tiles in dK/dV are 64 rows at d = 64 and 32 at d = 128, key tiles
// in dQ the same, so S, dP and the d-wide accumulators stay in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // keys per dK/dV block, queries per dQ block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdCfg {
  static constexpr int kTile = D == 64 ? 64 : 32;  // rows of the tile a block walks over
  static constexpr int kRS = D + 8;                // row-major tile stride (bf16)
  static constexpr int kTS = kTile + 8;            // transposed walked-tile stride
  // dK/dV: K, V [64][kRS]; Q, dO [kTile][kRS]; Q^T, dO^T [D][kTS]; lse, Di [kTile]
  static constexpr int kDkvSmem = 2 * kRows * kRS * 2 + 2 * kTile * kRS * 2 + 2 * D * kTS * 2 + 2 * kTile * 4;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Rows [row0, row0 + ROWS) of one (batch, head) slice of a [B, L, H, D]
// tensor (row stride `stride` elements) into shared memory: row-major into
// `rm` ([ROWS][D + 8]) and, when `tr` is given, transposed into `tr`
// ([D][ROWS + 8]). Rows at or past L read as zeros. 16-byte loads.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src, long stride, int row0, int L,
                                          __nv_bfloat16* rm, __nv_bfloat16* tr) {
  constexpr int VEC = 8, RS = D + 8, TS = ROWS + 8;
  for (int i = threadIdx.x; i < ROWS * D / VEC; i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    if (rm != nullptr) *reinterpret_cast<uint4*>(&rm[r * RS + c]) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tr[(c + j) * TS + r] = e[j];
    }
  }
}

// The A fragment (16 rows x 16 columns at column c0) of a row-major tile
// with row stride rs, rows r0..r0+15: thread (g, t) holds rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void a_frag(uint32_t a[4], const __nv_bfloat16* tile, int rs, int r0, int c0, int g,
                                       int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * rs + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * rs);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * rs + 8);
}

// The A fragment of one 16-column slice (kk) of an accumulator tile whose
// 8-column blocks are c[j][0..3]: the mma accumulator layout is the A layout.
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t a[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows r and r + 8 of a [L, H*D]-strided bf16 slice from accumulator blocks
// acc[D/8][4] times `mul`, columns 8j + 2t, 8j + 2t + 1; rows at or past L
// are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, long stride, int r, int L,
                                           const float (&acc)[D / 8][4], float mul, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r < L) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + c) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    }
    if (r + 8 < L) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * stride + c) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk, float scale_log2, float scale) {
  using C = BwdCfg<D>;
  constexpr int QT = C::kTile, RS = C::kRS, TS = C::kTS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][RS]
  __nv_bfloat16* v_s = k_s + kRows * RS;                              // [64][RS]
  __nv_bfloat16* q_s = v_s + kRows * RS;                              // [QT][RS]
  __nv_bfloat16* do_s = q_s + QT * RS;                                // [QT][RS]
  __nv_bfloat16* qt_s = do_s + QT * RS;                               // [D][TS]
  __nv_bfloat16* dot_s = qt_s + D * TS;                               // [D][TS]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * TS);            // [QT], times log2(e)
  float* di_s = lse_s + QT;                                           // [QT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kRows, kr = warp * 16;
  const long stride = static_cast<long>(H) * D;
  const long q_off = (static_cast<long>(b) * Lq * H + h) * D, k_off = (static_cast<long>(b) * Lk * H + h) * D;
  const float* lse_bh = lse + (static_cast<long>(b) * H + h) * Lq;
  const float* di_bh = di + (static_cast<long>(b) * H + h) * Lq;

  load_tile<D, kRows>(k + k_off, stride, k0, Lk, k_s, nullptr);
  load_tile<D, kRows>(v + k_off, stride, k0, Lk, v_s, nullptr);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    __syncthreads();  // the previous query tile is consumed (and K / V have landed)
    load_tile<D, QT>(q + q_off, stride, q0, Lq, q_s, qt_s);
    load_tile<D, QT>(dout + q_off, stride, q0, Lq, do_s, dot_s);
    for (int i = threadIdx.x; i < QT; i += kThreads) {
      const bool ok = q0 + i < Lq;
      lse_s[i] = ok ? lse_bh[q0 + i] * kLog2e : INFINITY;  // a query past Lq: P = 0
      di_s[i] = ok ? di_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x QT queries
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      a_frag(ak, k_s, RS, kr, kc * 16, g, t);
      a_frag(av, v_s, RS, kr, kc * 16, g, t);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const __nv_bfloat16* qp = q_s + (j * 8 + g) * RS + kc * 16 + 2 * t;
        const __nv_bfloat16* dp_row = do_s + (j * 8 + g) * RS + kc * 16 + 2 * t;
        mma_16816(s[j], ak, ld32(qp), ld32(qp + 8));
        mma_16816(dp[j], av, ld32(dp_row), ld32(dp_row + 8));
      }
    }

    // P^T and dS^T = P^T * (dP^T - Di); the column is the query
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[j][e], scale_log2, -lse_s[col]));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - di_s[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over this tile's queries, 16 at a time
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_as_a(pa, s, kk);
      acc_as_a(da, dp, kk);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* dot_p = dot_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        const __nv_bfloat16* qt_p = qt_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816(dv_acc[j], pa, ld32(dot_p), ld32(dot_p + 8));
        mma_16816(dk_acc[j], da, ld32(qt_p), ld32(qt_p + 8));
      }
    }
  }

  const int r = k0 + kr + g;
  store_rows<D>(dk + k_off, stride, r, Lk, dk_acc, scale, t);
  store_rows<D>(dv + k_off, stride, r, Lk, dv_acc, 1.f, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di, __nv_bfloat16* __restrict__ dq,
                        int H, int Lq, int Lk, float scale_log2, float scale) {
  using C = BwdCfg<D>;
  constexpr int KT = C::kTile, RS = C::kRS, TS = C::kTS;
  __shared__ __align__(16) __nv_bfloat16 k_s[KT * RS];   // row-major: B of S = Q K^T
  __shared__ __align__(16) __nv_bfloat16 v_s[KT * RS];   // row-major: B of dP = dO V^T
  __shared__ __align__(16) __nv_bfloat16 kt_s[D * TS];   // transposed: B of dQ = dS K

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const long stride = static_cast<long>(H) * D;
  const long q_off = (static_cast<long>(b) * Lq * H + h) * D, k_off = (static_cast<long>(b) * Lk * H + h) * D;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows
  const bool ok0 = r0 < Lq, ok1 = r1 < Lq;

  // Q and dO of the warp's 16 rows as A fragments, one set per 16 columns of d
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    const __nv_bfloat16* qb = q + q_off;
    const __nv_bfloat16* ob = dout + q_off;
    qf[kc][0] = ok0 ? ld32(qb + r0 * stride + c) : 0u;
    qf[kc][1] = ok1 ? ld32(qb + r1 * stride + c) : 0u;
    qf[kc][2] = ok0 ? ld32(qb + r0 * stride + c + 8) : 0u;
    qf[kc][3] = ok1 ? ld32(qb + r1 * stride + c + 8) : 0u;
    of[kc][0] = ok0 ? ld32(ob + r0 * stride + c) : 0u;
    of[kc][1] = ok1 ? ld32(ob + r1 * stride + c) : 0u;
    of[kc][2] = ok0 ? ld32(ob + r0 * stride + c + 8) : 0u;
    of[kc][3] = ok1 ? ld32(ob + r1 * stride + c + 8) : 0u;
  }
  const float* lse_bh = lse + (static_cast<long>(b) * H + h) * Lq;
  const float* di_bh = di + (static_cast<long>(b) * H + h) * Lq;
  const float lse0 = ok0 ? lse_bh[r0] * kLog2e : 0.f, lse1 = ok1 ? lse_bh[r1] * kLog2e : 0.f;
  const float di0 = ok0 ? di_bh[r0] : 0.f, di1 = ok1 ? di_bh[r1] : 0.f;

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  for (int n0 = 0; n0 < Lk; n0 += KT) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<D, KT>(k + k_off, stride, n0, Lk, k_s, kt_s);
    load_tile<D, KT>(v + k_off, stride, n0, Lk, v_s, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 queries x KT keys
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* kp = k_s + (j * 8 + g) * RS + 2 * t;
      const __nv_bfloat16* vp = v_s + (j * 8 + g) * RS + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        mma_16816(s[j], qf[kc], ld32(kp + kc * 16), ld32(kp + kc * 16 + 8));
        mma_16816(dp[j], of[kc], ld32(vp + kc * 16), ld32(vp + kc * 16 + 8));
      }
    }

    // dS = P * (dP - Di); keys past Lk have P = 0
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float p = col < Lk ? exp2f(fmaf(s[j][e], scale_log2, -(e < 2 ? lse0 : lse1))) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? di0 : di1));
      }
    }

    // dQ += dS K, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t da[4];
      acc_as_a(da, s, kk);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* kt_p = kt_s + (j * 8 + g) * TS + kk * 16 + 2 * t;
        mma_16816(dq_acc[j], da, ld32(kt_p), ld32(kt_p + 8));
      }
    }
  }

  store_rows<D>(dq + q_off, stride, r0, Lq, dq_acc, scale, t);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const __nv_bfloat16* dout,
           const float* lse, const float* di, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H,
           int Lq, int Lk, float scale, cudaStream_t s) {
  static uint64_t smem_set = 0;  // devices whose launch limit has been raised (a bit each)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = BwdCfg<D>::kDkvSmem;
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set |= uint64_t(1) << dev;
  }
  const float scale_log2 = scale * kLog2e;
  const dim3 grid_kv((Lk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, smem, s>>>(q, k, v, dout, lse, di, dk, dv, H, Lq, Lk, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((Lq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, 0, s>>>(q, k, v, dout, lse, di, dq, H, Lq, Lk, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: [B, Lq, H, D]; k, v, dk, dv: [B, Lk, H, D]; all bf16,
// contiguous, 16-byte aligned; lse, di: [B, H, Lq] f32; D in {64, 128};
// scale > 0. Launches the dK/dV kernel, then the dQ kernel, on `stream` and
// returns the first non-zero cudaGetLastError() (0 = both launched).
extern "C" int voxe_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                   const void* di, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                   float scale, void* stream) {
  if ((D != 64 && D != 128) || !(scale > 0.f) || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const auto* qp = static_cast<const bf*>(q);
  const auto* kp = static_cast<const bf*>(k);
  const auto* vp = static_cast<const bf*>(v);
  const auto* op = static_cast<const bf*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(di);
  auto* dqp = static_cast<bf*>(dq);
  auto* dkp = static_cast<bf*>(dk);
  auto* dvp = static_cast<bf*>(dv);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(qp, kp, vp, op, lp, dp, dqp, dkp, dvp, B, H, Lq, Lk, scale, s)
                 : launch<128>(qp, kp, vp, op, lp, dp, dqp, dkp, dvp, B, H, Lq, Lk, scale, s);
}
