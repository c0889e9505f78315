// Flash-attention backward for NVIDIA Hopper (sm_90a), bf16 in / f32
// accumulate / bf16 out, non-causal and unmasked. Given the forward's inputs
// q, k, v, its output o, its row log-sum-exp lse (written by
// csrc/flash_attn_fwd.cu) and the upstream gradient dO, with
// S = Q K^T * scale and Di = rowsum(dO * O):
//   P  = exp(S - lse)
//   dV = P^T dO
//   dS = P * (dO V^T - Di)
//   dK = dS^T Q * scale
//   dQ = dS K * scale
// without forming the [B, h, Lq, Lk] scores in device memory.
//
// Replaces: the custom VJP of JAX's library Pallas flash attention that
// voxe_tpu's UNet self-attention calls (voxe_tpu/models/sd/unet.py:156-171):
// `_flash_attention_bwd` in jax/experimental/pallas/ops/tpu/flash_attention.py
// (Di at :273), over its two kernels `_flash_attention_dkv_kernel`
// (pallas_call at :1121) and `_flash_attention_dq_kernel` (pallas_call at
// :1456). Wrapper: voxe_tpu_torch/ops/flash_attention.py.
//
// What bounds it, at the main shape (SD 2.x's 64x64 level, B=2, h=5,
// L=4096, d=64): the five products above are 2*B*h*L*L*d flops each, 107.4
// GFLOP, 0.109 ms at 989 TFLOP/s bf16; one exponential a score, 168 M exp2,
// about 43 us on the special-function units; the bytes (q, k, v, o, dO read,
// dq, dk, dv written, lse and Di) are about 42 MB, 0.0125 ms at 3.35 TB/s.
// So it is bound by the tensor cores.
//
// Design (after FlashAttention-3's backward), three launches a call:
//  * flash_bwd_pre_kernel: Di = rowsum(dO * O) in f32 from the bf16 tensors,
//    and lse * log2(e), into [B, h, Lq_pad] buffers (Lq_pad: Lq rounded up
//    to the query tile); the padding holds Di = 0 and lse = +inf, so P = 0
//    there and the main kernel has no ragged-query branch. It also zeroes the
//    f32 dQ workspace.
//  * flash_bwd_kernel: one block of three warpgroups per (128 keys, head,
//    batch): two consumers, then the producer. The producer warpgroup gives
//    its registers up (setmaxnreg.dec); one thread loads the block's K and V
//    once through TMA (maps over (d, h, L, B), 128-byte swizzle, rows past L
//    zero-filled), then streams
//    (Q, lse) and (dO, Di) query tiles into a 2-stage ring on full/empty
//    mbarriers (lse and Di as plain bulk copies of the padded rows). The two
//    consumer warpgroups take the registers (setmaxnreg.inc) and own 64 keys
//    each. For every query tile a warpgroup
//      - computes S^T = K Q^T and dP^T = V dO^T with wgmma, both operands
//        K-major in shared memory as TMA lays them down (dP^T in flight
//        while P^T is formed);
//      - forms P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and
//        dS^T = P^T * (dP^T - Di) in f32 registers: one exponential a score;
//        keys past Lk get P = 0 (a zero-filled K row scores 0, not -inf);
//      - writes dS^T (bf16) once into shared memory (double-buffered, the
//        128-byte swizzle), and after a barrier of both consumer warpgroups
//        issues its 64 x 64 share of dQ_partial = dS K first: A is dS^T read
//        MN-major, B the resident K tile, also MN-major;
//      - then dV += P^T dO and dK += dS^T Q with the register-A wgmma: the
//        accumulator layout is the A fragment's layout, and dO and Q are
//        MN-major B operands read through the transpose bit, so no tile is
//        stored a second time, transposed;
//      - while dV and dK are on the tensor cores, stages the f32 dQ partial
//        in shared memory in its register order and adds it into the f32
//        workspace with one bulk reduce-add (cp.reduce.async.bulk .add.f32,
//        16 KB), so the workspace is laid out by tiles in that order
//        ([B, h, Lq_pad / M, M * d]).
//    That makes 5 products and one exponential a score. dK (times scale)
//    and dV are written bf16 at the end; rows past Lk are not written.
//  * flash_bwd_post_kernel: dQ = workspace * scale -> bf16 [B, Lq, h, d],
//    reading the tile order and dropping the padding.
// dK and dV are bitwise the same from run to run (each block owns its keys);
// dQ is a sum of Lk / 128 partials added in the order the blocks finish, so
// it is not. The reduce-add moves n_blocks * Lq * d * 4 B through L2 (335 MB
// at the main shape) and costs less than recomputing S and dP in a second
// kernel would (PERF.md).
// Query tiles are 128 wide at d = 64 and 64 wide at d = 128, so each consumer
// thread holds S^T and dP^T (M/2 each) beside dK and dV (d/2 each): 192 f32
// accumulators at both head dimensions, under the 240 registers setmaxnreg
// gives a consumer. Shared memory, 2 stages: K + V 32 KB, Q + dO 2 x 32 KB,
// dS^T 2 x 32 KB, dQ staging 32 KB, lse + Di 2 KB = 194 KB at d = 64;
// K + V 64 KB, Q + dO 2 x 32 KB, dS^T 2 x 16 KB, staging 32 KB, 1 KB = 193
// KB at d = 128 (plus barriers and the 1 KB alignment slack the swizzle
// needs).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr int kBlockN = 128;         // keys per block: 2 consumer warpgroups x 64
constexpr int kThreads = 3 * 128;    // 2 consumer warpgroups, then the producer warpgroup
constexpr int kProducer = 2 * 128;   // the producer's one loading thread
constexpr int kStages = 2;           // query tiles in flight
constexpr int kBoxCols = 64;         // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int kRowBytes = 128;       // one row of a box
constexpr int kConsumerWarps = 8;    // arrivals that release a stage
constexpr int kChunkFloats = 64 * 64;  // one warpgroup's dQ partial of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPreRows = 64;         // query rows per preprocess block
constexpr int kPreThreads = 256;

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBoxCols;
  // queries per tile: 128 at d = 64, 64 at d = 128, so S^T, dP^T (M/2
  // registers each) and dK, dV (d/2 each) make 192 either way
  static constexpr int kBlockM = D == 64 ? 128 : 64;
  static constexpr int kKVBoxBytes = kBlockN * kRowBytes;
  static constexpr int kKVBytes = kBoxes * kKVBoxBytes;
  static constexpr int kQBoxBytes = kBlockM * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kVecBytes = kBlockM * 4;           // a tile's lse or Di
  static constexpr int kDsBoxBytes = kBlockN * kRowBytes;  // dS^T: [128 keys][64 queries]
  static constexpr int kDsBytes = (kBlockM / 64) * kDsBoxBytes;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKVBytes;
  static constexpr int kQOff = 2 * kKVBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kDsOff = kDoOff + kStages * kQBytes;
  static constexpr int kDqOff = kDsOff + 2 * kDsBytes;
  static constexpr int kLseOff = kDqOff + 2 * kChunkFloats * 4;
  static constexpr int kDiOff = kLseOff + kStages * kVecBytes;
  static constexpr int kBarOff = kDiOff + kStages * kVecBytes;
  // barriers: kv_full, q_full[S], do_full[S], empty[S]; 1 KB slack to align the base
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A wait
// that has not ended after 2^30 polls (seconds) is a bug: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// global[0:bytes/4] += shared[0:bytes/4] in f32, element by element, by the TMA unit
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address >> 4 (bits 0-13), leading and stride byte offsets >> 4 (bits 16-29,
// 32-45), layout type 1 = 128-byte swizzle (bits 62-63). Every operand here
// has 128-byte rows, so the step between 8-row groups is 1024 B; within one
// instruction no operand spans a second 64-column swizzle atom, so the other
// offset is never stepped, and it is set to 1024 B as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue and wait points.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int C, int N>
__device__ __forceinline__ void reg_fence(float (&r)[C][N]) {
#pragma unroll
  for (int c = 0; c < C; ++c) reg_fence(r[c]);
}

// d[64] (+)= A[64 x 16] B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[32] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n128k16_ss(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n64k16_ss(d, a, b, acc);
}

// d[32] (+)= A[64 x 16] B[16 x 64]; A and B MN-major in shared memory (both
// transpose bits set).
__device__ __forceinline__ void wgmma_m64n64k16_ss_tt(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[32] += A[64 x 16] B[16 x 64]; A in registers (bf16 pairs), B MN-major in
// shared memory (the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                      uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc = A B^T for this warpgroup's 64 rows of A (K or V, `a_rows`) against a
// whole query tile (Q or dO, `tile`): d/16 steps of 16 columns, both K-major.
template <int D>
__device__ __forceinline__ void issue_t(float (&acc)[Cfg<D>::kBlockM / 2], uint32_t a_rows, uint32_t tile) {
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    const uint32_t col = (t % 4) * 32;  // 16 columns = 32 B into the box
    wgmma_ss(acc, sw128_desc(a_rows + (t / 4) * Cfg<D>::kKVBoxBytes + col),
             sw128_desc(tile + (t / 4) * Cfg<D>::kQBoxBytes + col), t > 0);
  }
}

// acc += A tile over one query tile: A (P^T or dS^T) in registers, 16
// queries a step, one instruction per 64-column box of d; a[4t..4t+3] hold
// queries 16t..16t+15. The tile (dO or Q) is an MN-major B operand.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 64][32], const uint32_t (&a)[Cfg<D>::kBlockM / 4],
                                         uint32_t tile) {
#pragma unroll
  for (int t = 0; t < Cfg<D>::kBlockM / 16; ++t) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      wgmma_m64n64k16_rs_tb(acc[c], a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3],
                            sw128_desc(tile + c * Cfg<D>::kQBoxBytes + t * 16 * kRowBytes));
    }
  }
}

template <int D>
__device__ __forceinline__ void consumer(int wg, const uint8_t* sp, uint32_t base, float* __restrict__ dq_ws,
                                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                                         int Lk, int n_qt, float scale_log2, float scale) {
  using C = Cfg<D>;
  constexpr int S = kStages, M = C::kBlockM;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t4 = lane & 3;
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff, q_s = base + C::kQOff, do_s = base + C::kDoOff;
  const uint32_t ds_s = base + C::kDsOff, bar = base + C::kBarOff;
  auto q_full = [&](int st) { return bar + 8 * (1 + st); };
  auto do_full = [&](int st) { return bar + 8 * (1 + S + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + 2 * S + st); };
  const uint32_t k_wg = k_s + wg * 64 * kRowBytes, v_wg = v_s + wg * 64 * kRowBytes;  // this warpgroup's keys
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // this thread's key rows in the block: r0 and r0 + 8
  const int key0 = blockIdx.x * kBlockN + r0;
  const bool ok0 = key0 < Lk, ok1 = key0 + 8 < Lk;
  // this warpgroup's 64 x 64 share of a tile's dQ: query box qb, column box cb
  const int qb = D == 64 ? wg : 0, cb = D == 64 ? 0 : wg;
  const uint32_t stage_dq = base + C::kDqOff + wg * kChunkFloats * 4;
  float* dq_bh = dq_ws + (static_cast<long>(b) * H + h) * n_qt * M * D + (qb * (D / 64) + cb) * kChunkFloats;

  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  }
  float s[M / 2], dp[M / 2], dq[32];
  uint32_t p[M / 4], ds[M / 4];

  mbar_wait(bar, 0);  // K and V
  for (int j = 0; j < n_qt; ++j) {
    const int st = j % S;
    const uint32_t ph = (j / S) & 1;
    const uint32_t q_t = q_s + st * C::kQBytes, do_t = do_s + st * C::kQBytes;
    const float* lse_t = reinterpret_cast<const float*>(sp + C::kLseOff + st * C::kVecBytes);
    const float* di_t = reinterpret_cast<const float*>(sp + C::kDiOff + st * C::kVecBytes);

    // S^T = K Q^T, then dP^T = V dO^T (in flight while P^T is formed)
    mbar_wait(q_full(st), ph);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    issue_t<D>(s, k_wg, q_t);
    wgmma_commit();
    mbar_wait(do_full(st), ph);
    issue_t<D>(dp, v_wg, do_t);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);

    // P^T; accumulator register 4j+e holds key row r0 + 8*(e/2) and query
    // column 8j + 2*(lane%4) + e%2 of the tile
#pragma unroll
    for (int jj = 0; jj < M / 8; ++jj) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * jj + 2 * t4);
      s[4 * jj] = ex2(fmaf(s[4 * jj], scale_log2, -l.x));
      s[4 * jj + 1] = ex2(fmaf(s[4 * jj + 1], scale_log2, -l.y));
      s[4 * jj + 2] = ex2(fmaf(s[4 * jj + 2], scale_log2, -l.x));
      s[4 * jj + 3] = ex2(fmaf(s[4 * jj + 3], scale_log2, -l.y));
    }
    if (!(ok0 && ok1)) {  // keys past Lk (the last block only)
#pragma unroll
      for (int jj = 0; jj < M / 8; ++jj) {
        if (!ok0) s[4 * jj] = s[4 * jj + 1] = 0.f;
        if (!ok1) s[4 * jj + 2] = s[4 * jj + 3] = 0.f;
      }
    }
    wgmma_wait<0>();
    reg_fence(dp);
    // dS^T = P^T * (dP^T - Di)
#pragma unroll
    for (int jj = 0; jj < M / 8; ++jj) {
      const float2 d = *reinterpret_cast<const float2*>(di_t + 8 * jj + 2 * t4);
      dp[4 * jj] = s[4 * jj] * (dp[4 * jj] - d.x);
      dp[4 * jj + 1] = s[4 * jj + 1] * (dp[4 * jj + 1] - d.y);
      dp[4 * jj + 2] = s[4 * jj + 2] * (dp[4 * jj + 2] - d.x);
      dp[4 * jj + 3] = s[4 * jj + 3] * (dp[4 * jj + 3] - d.y);
    }
#pragma unroll
    for (int i = 0; i < M / 4; ++i) {
      p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }

    // dS^T into shared memory, [128 keys][64 queries] a box in the 128-byte
    // swizzle (16-byte chunk k of row r at chunk k ^ (r % 8)); conflict-free
    const uint32_t ds_buf = ds_s + (j & 1) * C::kDsBytes;
#pragma unroll
    for (int jj = 0; jj < M / 8; ++jj) {
      const uint32_t at = ds_buf + (jj / 8) * C::kDsBoxBytes + r0 * kRowBytes + (((jj % 8) ^ (r0 & 7)) * 16) + t4 * 4;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(ds[2 * jj]) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * kRowBytes), "r"(ds[2 * jj + 1]) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    // the staging buffer is free once the last tile's reduce-add has read
    // it; the barrier below tells the warpgroup
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    // both warpgroups' dS^T rows are in (the buffer alternates, so one
    // barrier a tile also keeps a warpgroup from overwriting rows the other
    // still reads)
    asm volatile("bar.sync 3, 256;\n" ::: "memory");

    // dQ_partial = dS K for this warpgroup's 64 x 64 share first, then
    // dV += P^T dO and dK += dS^T Q, so the partial is staged and reduced
    // while dV and dK are on the tensor cores
    reg_fence(dq);
    reg_fence(p);
    reg_fence(ds);
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
      wgmma_m64n64k16_ss_tt(dq, sw128_desc(ds_buf + qb * C::kDsBoxBytes + t * 16 * kRowBytes),
                            sw128_desc(k_s + cb * C::kKVBoxBytes + t * 16 * kRowBytes), t > 0);
    }
    wgmma_commit();
    issue_rs<D>(dv_acc, p, do_t);
    issue_rs<D>(dk_acc, ds, q_t);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(dq);

    // the partial into the staging buffer in register order (pair i of
    // thread tid at float 2 * (128 i + tid)), then one bulk reduce-add
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(stage_dq + (i * 128 + tid) * 8), "f"(dq[2 * i]),
                   "f"(dq[2 * i + 1])
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      bulk_reduce_add(dq_bh + static_cast<long>(j) * M * D, stage_dq, kChunkFloats * 4);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    wgmma_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(p);
    reg_fence(ds);
    if (lane == 0) mbar_arrive(empty(st));  // this tile's Q, dO, lse and Di are consumed
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // dK * scale and dV, bf16, rows past Lk not written
  const long stride = static_cast<long>(H) * D;
  __nv_bfloat16* dk_row = dk + (static_cast<long>(b) * Lk + key0) * stride + h * D;
  __nv_bfloat16* dv_row = dv + (static_cast<long>(b) * Lk + key0) * stride + h * D;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c * 64 + 8 * jj + 2 * t4;
      if (ok0) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
            __floats2bfloat162_rn(dk_acc[c][4 * jj] * scale, dk_acc[c][4 * jj + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
            __floats2bfloat162_rn(dv_acc[c][4 * jj], dv_acc[c][4 * jj + 1]);
      }
      if (ok1) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * stride + col) =
            __floats2bfloat162_rn(dk_acc[c][4 * jj + 2] * scale, dk_acc[c][4 * jj + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * stride + col) =
            __floats2bfloat162_rn(dv_acc[c][4 * jj + 2], dv_acc[c][4 * jj + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse2, const float* __restrict__ di, float* __restrict__ dq_ws,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Lk, int n_qt,
                     float scale_log2, float scale) {
  using C = Cfg<D>;
  constexpr int S = kStages, M = C::kBlockM;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 B; tiles start on that boundary
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* sp = smem_raw + (base - raw);
  const uint32_t bar = base + C::kBarOff;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);  // kv_full: the producer's expect_tx
    for (int st = 0; st < S; ++st) {
      mbar_init(bar + 8 * (1 + st), 1);                       // q_full
      mbar_init(bar + 8 * (1 + S + st), 1);                   // do_full
      mbar_init(bar + 8 * (1 + 2 * S + st), kConsumerWarps);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role goes through a shuffle so that ptxas can prove it uniform
  // across each warp, as setmaxnreg asks: the consumers' 192 accumulators
  // fit only in setmaxnreg's 240 registers, and code held to the launch's
  // 168 spills and serialises the wgmma (ptxas C7512). With the role from
  // threadIdx.x / 128 the d = 128 build spills 8 B (PERF.md;
  // flash_bwd_ablations.py).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer<D>(wg, sp, base, dq_ws, dk, dv, H, Lk, n_qt, scale_log2, scale);
  } else {
    // producer: the warpgroup frees its registers; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kProducer) {
      const int h = blockIdx.y, b = blockIdx.z, key0 = blockIdx.x * kBlockN;
      const long vec0 = (static_cast<long>(b) * H + h) * n_qt * M;  // this (b, h)'s row of lse2 and Di
      mbar_expect_tx(bar, 2 * C::kKVBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_4d(base + C::kKOff + c * C::kKVBoxBytes, &tm_k, bar, c * kBoxCols, h, key0, b);
        tma_load_4d(base + C::kVOff + c * C::kKVBoxBytes, &tm_v, bar, c * kBoxCols, h, key0, b);
      }
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % S;
        mbar_wait(bar + 8 * (1 + 2 * S + st), ((j / S) & 1) ^ 1);  // free (passes at once on the first round)
        const uint32_t qf = bar + 8 * (1 + st), df = bar + 8 * (1 + S + st);
        mbar_expect_tx(qf, C::kQBytes + C::kVecBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(base + C::kQOff + st * C::kQBytes + c * C::kQBoxBytes, &tm_q, qf, c * kBoxCols, h, j * M, b);
        }
        bulk_load(base + C::kLseOff + st * C::kVecBytes, lse2 + vec0 + j * M, C::kVecBytes, qf);
        mbar_expect_tx(df, C::kQBytes + C::kVecBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(base + C::kDoOff + st * C::kQBytes + c * C::kQBoxBytes, &tm_do, df, c * kBoxCols, h, j * M,
                      b);
        }
        bulk_load(base + C::kDiOff + st * C::kVecBytes, di + vec0 + j * M, C::kVecBytes, df);
      }
    }
  }
}

// Di = rowsum(dO * O) in f32 and lse * log2(e) into [B, H, Lq_pad] (Di = 0
// and +inf past Lq), and zeroes this block's rows of the dQ workspace. One
// block per (64 query rows, head, batch); D/8 threads a row, 16 bytes each.
template <int D>
__global__ void __launch_bounds__(kPreThreads)
    flash_bwd_pre_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ di, float* __restrict__ lse2,
                         float* __restrict__ dq_ws, int H, int Lq, int Lq_pad) {
  constexpr int CH = D / 8, RPP = kPreThreads / CH;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kPreRows, c = threadIdx.x % CH;
  const long bh = static_cast<long>(b) * H + h;
  for (int r = threadIdx.x / CH; r < kPreRows; r += RPP) {
    const int q = q0 + r;
    float acc = 0.f;
    if (q < Lq) {
      const long off = ((static_cast<long>(b) * Lq + q) * H + h) * D + c * 8;
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a bf16 is the high half of its f32
        acc = fmaf(__uint_as_float(ow[e] << 16), __uint_as_float(dw[e] << 16), acc);
        acc = fmaf(__uint_as_float(ow[e] & 0xffff0000u), __uint_as_float(dw[e] & 0xffff0000u), acc);
      }
    }
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (c == 0) {
      di[bh * Lq_pad + q] = acc;
      lse2[bh * Lq_pad + q] = q < Lq ? lse[bh * Lq + q] * kLog2e : INFINITY;
    }
  }
  float4* w = reinterpret_cast<float4*>(dq_ws + (bh * Lq_pad + q0) * D);
  for (int i = threadIdx.x; i < kPreRows * D / 4; i += kPreThreads) w[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq [B, Lq, H, D] bf16 = workspace * scale. The workspace holds each
// (b, h)'s tiles of M queries one after another; inside a tile, chunk
// qb * (D / 64) + cb (queries 64 qb.., columns 64 cb..) of 4096 floats is in
// the consumer's register order: float 2 * (128 i + tid) + e holds row
// 16 (tid / 32) + (tid % 32) / 4 + 8 (i % 2), column 8 (i / 2) + 2 (tid % 4) + e.
template <int D>
__global__ void flash_bwd_post_kernel(const float* __restrict__ dq_ws, __nv_bfloat16* __restrict__ dq, int H,
                                      int Lq, int Lq_pad, float scale, long n_pairs) {
  constexpr int M = Cfg<D>::kBlockM;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n_pairs;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % (D / 2)) * 2;
    long rest = i / (D / 2);
    const int h = static_cast<int>(rest % H);
    rest /= H;
    const int q = static_cast<int>(rest % Lq);
    const long b = rest / Lq;
    const int qi = q % M, r = qi % 64, cc = c % 64;
    const int chunk = (qi / 64) * (D / 64) + c / 64;
    const int tid = (r / 16) * 32 + (r % 8) * 4 + (cc % 8) / 2;
    const int pair = (cc / 8) * 2 + (r % 16) / 8;
    const long off = ((b * H + h) * Lq_pad + (q - qi)) * D + chunk * kChunkFloats + (pair * 128 + tid) * 2;
    const float2 v = *reinterpret_cast<const float2*>(dq_ws + off);
    *reinterpret_cast<__nv_bfloat162*>(dq + i * 2) = __floats2bfloat162_rn(v.x * scale, v.y * scale);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [B, L, H, D] bf16 -> a map over (D, H, L, B), box (64, 1, rows, 1), 128-byte swizzle,
// out-of-range rows read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int L, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int B, int H, int Lq,
               int Lk, int D) {
  EncodeTiled enc = encode_tiled();
  const int rows = D == 64 ? Cfg<64>::kBlockM : Cfg<128>::kBlockM;
  return enc != nullptr && make_map(enc, &m->q, q, B, Lq, H, D, rows) &&
         make_map(enc, &m->k, k, B, Lk, H, D, kBlockN) && make_map(enc, &m->v, v, B, Lk, H, D, kBlockN) &&
         make_map(enc, &m->dout, dout, B, Lq, H, D, rows);
}

template <int D>
int launch(const Maps& m, const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, float* di,
           float* lse2, float* dq_ws, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int Lq,
           int Lk, float scale, cudaStream_t s) {
  using C = Cfg<D>;
  static uint64_t smem_set = 0;  // devices whose launch limit has been raised (a bit each)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set |= uint64_t(1) << dev;
  }
  const int n_qt = (Lq + C::kBlockM - 1) / C::kBlockM, Lq_pad = n_qt * C::kBlockM;
  flash_bwd_pre_kernel<D><<<dim3(Lq_pad / kPreRows, H, B), kPreThreads, 0, s>>>(o, dout, lse, di, lse2, dq_ws, H, Lq,
                                                                                Lq_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kernel<D><<<dim3((Lk + kBlockN - 1) / kBlockN, H, B), kThreads, C::kSmemBytes, s>>>(
      m.q, m.k, m.v, m.dout, lse2, di, dq_ws, dk, dv, H, Lk, n_qt, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n_pairs = static_cast<long>(B) * Lq * H * D / 2;
  const long blocks = (n_pairs + 255) / 256;
  flash_bwd_post_kernel<D><<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      dq_ws, dq, H, Lq, Lq_pad, scale, n_pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: [B, Lq, H, D]; k, v, dk, dv: [B, Lk, H, D]; all bf16,
// contiguous, 16-byte aligned; lse: [B, H, Lq] f32 (the forward's); di,
// lse2: [B, H, Lq_pad] f32 and dq_ws: [B, H, Lq_pad, D] f32 scratch, written
// here (Lq_pad = Lq rounded up to q_tile, which must be the kernel's query
// tile for D: 128 at D = 64, 64 at D = 128); D in {64, 128}; scale > 0.
// Encodes the four TMA descriptors, launches the
// preprocess, main and postprocess kernels on `stream` and returns the first
// non-zero cudaGetLastError() (0 = all three launched).
extern "C" int voxe_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   const void* lse, void* di, void* lse2, void* dq_ws, void* dq, void* dk, void* dv,
                                   int B, int H, int Lq, int Lk, int D, int q_tile, float scale, void* stream) {
  if ((D != 64 && D != 128) || !(scale > 0.f) || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q_tile != (D == 64 ? Cfg<64>::kBlockM : Cfg<128>::kBlockM)) return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const auto* op = static_cast<const bf*>(o);
  const auto* dop = static_cast<const bf*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dip = static_cast<float*>(di);
  auto* l2p = static_cast<float*>(lse2);
  auto* wp = static_cast<float*>(dq_ws);
  auto* dqp = static_cast<bf*>(dq);
  auto* dkp = static_cast<bf*>(dk);
  auto* dvp = static_cast<bf*>(dv);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(m, op, dop, lp, dip, l2p, wp, dqp, dkp, dvp, B, H, Lq, Lk, scale, s)
                 : launch<128>(m, op, dop, lp, dip, l2p, wp, dqp, dkp, dvp, B, H, Lq, Lk, scale, s);
}

// Host cost of encoding the four descriptors of one call, in microseconds,
// averaged over `iters` encodings (nothing is launched).
extern "C" double voxe_flash_attn_bwd_encode_us(const void* q, const void* k, const void* v, const void* dout, int B,
                                                int H, int Lq, int Lk, int D, int iters) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, H, Lq, Lk, D)) return -1.0;  // also resolves the entry point
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) make_maps(&m, q, k, v, dout, B, H, Lq, Lk, D);
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
