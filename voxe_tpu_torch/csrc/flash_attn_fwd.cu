// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 in / f32 accumulate
// / bf16 out, non-causal and unmasked: O = softmax(Q K^T * scale) V.
//
// Replaces: the Pallas TPU kernel that voxe_tpu's UNet self-attention calls,
// voxe_tpu/models/sd/unet.py:156-171 (JAX's library
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, forward;
// gate unet.py:57-80). Wrapper: voxe_tpu_torch/ops/flash_attention.py.
//
// What bounds it, at the main shape (SD 2.x's 64x64 level, B=2 for CFG, h=5,
// Q=K=4096, d=64):
//  * the tensor cores: 4*B*h*Q*K*d = 42.9 GFLOP, 43.4 us at 989 TFLOP/s bf16;
//  * the exponentials: B*h*Q*K = 168 M exp2 on the special-function units
//    (16 a clock on each of 132 SMs, about 3.9 T/s), about 43 us as well;
//  * the bytes (q, k, v, o: 21.0 MB, 6.3 us at 3.35 TB/s) are far below both.
// A kernel that runs its softmax after its matrix products, instead of beside
// them, adds the two 43 us floors and cannot pass about half of the bound.
//
// Design (after FlashAttention-3):
//  * layout [B, L, h, d] (row stride h*d), so the UNet needs no transposes.
//    Each tensor has a TMA descriptor over (d, h, L, B), innermost first,
//    with a box of (64, 1, rows, 1) and a 128-byte swizzle: a tile never
//    crosses into the next head or batch, and rows past L inside the box are
//    zero-filled by the hardware (and clipped on the store). d = 128 is two
//    64-column boxes per tile.
//  * one block of three warpgroups per (128 query rows, head, batch). The
//    producer warpgroup gives its registers up (setmaxnreg.dec); one thread
//    loads Q once and keeps a ring of K/V stages in flight with TMA, each
//    stage behind full/empty mbarriers (K and V have their own full barrier,
//    so QK^T starts before V lands). The two consumer warpgroups take the
//    registers (setmaxnreg.inc) and own 64 query rows each; every K/V tile
//    is read by both, so it serves 128 query rows.
//  * S = Q K^T with wgmma m64n128k16, both operands in shared memory (K is
//    K-major as TMA lays it down), f32 accumulators in registers.
//  * the online softmax in base 2 with scale*log2(e) folded into one FMA per
//    score, the row max and sum reduced over the 4 threads that share a row;
//    keys >= Lk in the last tile are masked to -inf (their zero-filled rows
//    would score 0, not -inf).
//  * O += P V with the register-A wgmma (m64n64k16 per 64-column box of d):
//    P is rounded to bf16 in the accumulator's own layout, which is the A
//    fragment's layout; V is read from shared memory as an MN-major B operand
//    through wgmma's transpose bit, so nothing transposes V.
//  * the exponentials overlap the tensor cores (FlashAttention-3's two-stage
//    pipelining inside a warpgroup): tile j's QK^T and tile j-1's PV are
//    issued together, and tile j's softmax runs while that PV is in flight
//    (wgmma.wait_group 1); the two consumer warpgroups also interleave on
//    the SM's schedulers.
//  * epilogue: divide by the row sum, round to bf16, stage the tile in the
//    warpgroup's own (consumed) Q rows in the swizzled layout, TMA store.
//    When the caller passes an lse buffer ([B, h, Lq] f32; the backward's
//    residual, csrc/flash_attn_bwd.cu), the quad that owns a row also writes
//    its log-sum-exp, m * scale + ln(l), from the running max and sum it
//    already holds: 4 bytes a row, nothing recomputed. The write is a
//    template switch (kLse): a null lse launches the instantiation without
//    it, the same code a no-grad call ran before the backward existed.
//  * 320 tiles at the main shape on 132 SMs, one block an SM: 2.42 waves.
// Key tiles are 128 wide at d = 64 and 64 wide at d = 128, where S (n/2
// registers a thread), P (n/4) and O (d/2) would otherwise pass the 168
// registers the launch allows and ptxas would serialise the wgmma.
// Shared memory, 3 K/V stages: Q 16 KB + 3 x (K 16 KB + V 16 KB) = 112 KB at
// d = 64; Q 32 KB + 3 x (16 + 16) KB = 128 KB at d = 128 (plus barriers and
// the 1 KB alignment slack the swizzle needs).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr int kBlockM = 128;            // query rows per block: 2 consumer warpgroups x 64
constexpr int kThreads = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 3;              // K/V tiles in flight
constexpr int kBoxCols = 64;            // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int kQBoxBytes = kBlockM * 128;  // one 64-column box of the Q tile: 16 KB
constexpr int kWgRowsBytes = 64 * 128;  // a consumer warpgroup's 64 rows of a Q box: 8 KB
constexpr int kConsumerWarps = 8;       // arrivals that release a K/V stage

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBoxCols;
  // keys per K/V tile: 128 at d = 64; 64 at d = 128, where S (n/2), P (n/4)
  // and O (d/2) registers a thread would otherwise pass the launch's 168
  static constexpr int kBlockN = D == 64 ? 128 : 64;
  static constexpr int kKVBoxBytes = kBlockN * 128;
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;
  static constexpr int kKVTileBytes = kBoxes * kKVBoxBytes;
  static constexpr int kKOff = kQTileBytes;  // Q sits at 0
  static constexpr int kVOff = kKOff + kStages * kKVTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVTileBytes;
  // barriers: q_full, k_full[S], v_full[S], empty[S]; 1 KB slack to align the base
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 3 * kStages) + 1024;
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

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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

// S = Q K^T for this warpgroup's 64 rows and one key tile: d/16 steps.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<D>::kBlockN / 2], uint32_t q_wg, uint32_t k_tile) {
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    const uint32_t col = (t % 4) * 32;  // 16 columns = 32 B into the box
    wgmma_ss(s, sw128_desc(q_wg + (t / 4) * kQBoxBytes + col), sw128_desc(k_tile + (t / 4) * Cfg<D>::kKVBoxBytes + col),
             t > 0);
  }
}

// O += P V over one key tile: steps of 16 keys, one instruction per 64-column
// box of d. P's registers for keys 16t..16t+15 are p[4t..4t+3].
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32], const uint32_t (&p)[Cfg<D>::kBlockN / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int t = 0; t < Cfg<D>::kBlockN / 16; ++t) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      wgmma_m64n64k16_rs_tb(o[c], p[4 * t], p[4 * t + 1], p[4 * t + 2], p[4 * t + 3],
                            sw128_desc(v_tile + c * Cfg<D>::kKVBoxBytes + t * 16 * 128));
    }
  }
}

// Online softmax over one tile of scores. Accumulator register 4j+e of this
// thread holds row (g + 8*(e/2)) and key column (8j + 2*(lane%4) + e%2) of the
// tile. On return s holds the unnormalised probabilities, m0/m1 the new row
// maxima (raw score units), l0/l1 this thread's share of the row sums, and
// a0/a1 the factors by which earlier sums and outputs must be rescaled.
template <int N, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float& m0, float& m1, float& l0, float& l1,
                                             float& a0, float& a1, float scale_log2, int n_valid, int lane) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * (lane & 3) + (e & 1) >= n_valid) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every tile holds a valid key, so mx0/mx1 are finite; the first tile's
  // m = -inf gives a = 0 (nothing to rescale yet)
  a0 = ex2((m0 - mx0) * scale_log2);
  a1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float b0 = mx0 * scale_log2, b1 = mx1 * scale_log2;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -b1));
    r0 += s[4 * j] + s[4 * j + 1];
    r1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
}

template <int N>
__device__ __forceinline__ void softmax_any(float (&s)[N / 2], float& m0, float& m1, float& l0, float& l1,
                                            float& a0, float& a1, float scale_log2, int n_valid, int lane) {
  if (n_valid < N) {
    softmax_tile<N, true>(s, m0, m1, l0, l1, a0, a1, scale_log2, n_valid, lane);
  } else {
    softmax_tile<N, false>(s, m0, m1, l0, l1, a0, a1, scale_log2, n_valid, lane);
  }
}

template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 4], const float (&s)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D, bool kLse>
__device__ __forceinline__ void consumer(int wg, uint32_t q_s, uint32_t k_s, uint32_t v_s, uint32_t bar,
                                         const CUtensorMap* tm_o, float* __restrict__ lse, int Lq, int Lk,
                                         float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = kStages, N = C::kBlockN;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + S + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + 2 * S + st); };
  const uint32_t q_wg = q_s + wg * kWgRowsBytes;  // this warpgroup's rows of each Q box
  const int n_tiles = (Lk + N - 1) / N;

  float o[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  }
  float s[N / 2];
  uint32_t p[N / 4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

  // tile 0: S = Q K0^T, its softmax, P
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  reg_fence(s);
  wgmma_fence();
  issue_qk<D>(s, q_wg, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  softmax_any<N>(s, m0, m1, l0, l1, a0, a1, scale_log2, min(Lk, N), lane);
  pack_p<N>(p, s);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % S, prev = (j - 1) % S;
    mbar_wait(k_full(st), (j / S) & 1);
    reg_fence(s);
    reg_fence(p);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) reg_fence(o[c]);
    wgmma_fence();
    issue_qk<D>(s, q_wg, k_s + st * C::kKVTileBytes);  // S = Q K_j^T
    wgmma_commit();
    mbar_wait(v_full(prev), ((j - 1) / S) & 1);
    issue_pv<D>(o, p, v_s + prev * C::kKVTileBytes);  // O += P_{j-1} V_{j-1}
    wgmma_commit();
    wgmma_wait<1>();  // S is ready; PV stays in flight under the softmax
    reg_fence(s);
    softmax_any<N>(s, m0, m1, l0, l1, a0, a1, scale_log2, min(Lk - j * N, N), lane);
    wgmma_wait<0>();
    reg_fence(p);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) reg_fence(o[c]);
    if (lane == 0) mbar_arrive(empty(prev));  // stage j-1's K and V are consumed
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        o[c][i] *= a0;
        o[c][i + 1] *= a0;
        o[c][i + 2] *= a1;
        o[c][i + 3] *= a1;
      }
    }
    pack_p<N>(p, s);
  }

  // the last tile's PV
  const int last = (n_tiles - 1) % S;
  mbar_wait(v_full(last), ((n_tiles - 1) / S) & 1);
  reg_fence(p);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) reg_fence(o[c]);
  wgmma_fence();
  issue_pv<D>(o, p, v_s + last * C::kKVTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < D / 64; ++c) reg_fence(o[c]);
  if (lane == 0) mbar_arrive(empty(last));

  // epilogue: O / l in bf16, staged in this warpgroup's Q rows (consumed) in
  // the 128-byte swizzle the store map expects (16-byte chunk k of row r at
  // chunk k ^ (r % 8)); conflict-free: the 32 lanes hit 32 distinct banks
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the warpgroup's 64
  if (kLse && (lane & 3) == 0) {
    // natural-log units of the scaled scores: ln(sum_j exp(s_j * scale))
    constexpr float kLn2 = 0.6931471805599453f;
    const int row = blockIdx.x * kBlockM + wg * 64 + r0;
    float* lse_bh = lse + (static_cast<long>(blockIdx.z) * gridDim.y + blockIdx.y) * Lq;
    if (row < Lq) lse_bh[row] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (row + 8 < Lq) lse_bh[row + 8] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    const uint32_t box = q_wg + c * kQBoxBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t chunk = ((j ^ (r0 & 7)) * 16) + (lane & 3) * 4;
      const uint32_t v0 = pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      const uint32_t v1 = pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(box + r0 * 128 + chunk), "r"(v0) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(box + (r0 + 8) * 128 + chunk), "r"(v1) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // make the writes visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  const int row = blockIdx.x * kBlockM + wg * 64;
  if (tid == 0 && row < Lq) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_store_4d(tm_o, q_wg + c * kQBoxBytes, c * kBoxCols, blockIdx.y, row, blockIdx.z);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                     float* __restrict__ lse, int Lq, int Lk, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 B; tiles start on that boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff, bar = base + C::kBarOff;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bar + 8 * (1 + st), 1);          // k_full: the producer's expect_tx
      mbar_init(bar + 8 * (1 + S + st), 1);      // v_full
      mbar_init(bar + 8 * (1 + 2 * S + st), kConsumerWarps);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup frees its registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int h = blockIdx.y, b = blockIdx.z, n_tiles = (Lk + C::kBlockN - 1) / C::kBlockN;
      mbar_expect_tx(bar, C::kQTileBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_4d(q_s + c * kQBoxBytes, &tm_q, bar, c * kBoxCols, h, blockIdx.x * kBlockM, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % S;
        mbar_wait(bar + 8 * (1 + 2 * S + st), ((j / S) & 1) ^ 1);  // free (passes at once on the first round)
        const uint32_t kf = bar + 8 * (1 + st), vf = bar + 8 * (1 + S + st);
        const uint32_t k_dst = k_s + st * C::kKVTileBytes, v_dst = v_s + st * C::kKVTileBytes;
        mbar_expect_tx(kf, C::kKVTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(k_dst + c * C::kKVBoxBytes, &tm_k, kf, c * kBoxCols, h, j * C::kBlockN, b);
        }
        mbar_expect_tx(vf, C::kKVTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_4d(v_dst + c * C::kKVBoxBytes, &tm_v, vf, c * kBoxCols, h, j * C::kBlockN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consumer<D, kLse>(wg - 1, q_s, k_s, v_s, bar, &tm_o, lse, Lq, Lk, scale_log2);
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
// out-of-range rows read as zeros and are not written.
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
  CUtensorMap q, k, v, o;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* o, int B, int H, int Lq, int Lk,
               int D) {
  EncodeTiled enc = encode_tiled();
  const int n = D == 64 ? Cfg<64>::kBlockN : Cfg<128>::kBlockN;
  return enc != nullptr && make_map(enc, &m->q, q, B, Lq, H, D, kBlockM) && make_map(enc, &m->k, k, B, Lk, H, D, n) &&
         make_map(enc, &m->v, v, B, Lk, H, D, n) && make_map(enc, &m->o, o, B, Lq, H, D, 64);
}

template <int D, bool kLse>
int launch(const Maps& m, float* lse, int B, int H, int Lq, int Lk, float scale_log2, cudaStream_t s) {
  static uint64_t smem_set = 0;  // devices whose launch limit has been raised (a bit each)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<D>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set |= uint64_t(1) << dev;
  }
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D, kLse><<<grid, kThreads, Cfg<D>::kSmemBytes, s>>>(m.q, m.k, m.v, m.o, lse, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, Lq, H, D]; k, v: [B, Lk, H, D]; all bf16, contiguous, 16-byte
// aligned; D in {64, 128}; scale > 0. lse: null, or [B, H, Lq] f32 that
// receives each row's log-sum-exp of the scaled scores. Encodes the four TMA
// descriptors, launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int voxe_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                                   int Lq, int Lk, int D, float scale, void* stream) {
  if ((D != 64 && D != 128) || !(scale > 0.f) || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  if (!make_maps(&m, q, k, v, o, B, H, Lq, Lk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (l == nullptr) {
    return D == 64 ? launch<64, false>(m, l, B, H, Lq, Lk, scale_log2, s)
                   : launch<128, false>(m, l, B, H, Lq, Lk, scale_log2, s);
  }
  return D == 64 ? launch<64, true>(m, l, B, H, Lq, Lk, scale_log2, s)
                 : launch<128, true>(m, l, B, H, Lq, Lk, scale_log2, s);
}

// Host cost of encoding the four descriptors of one call, in microseconds,
// averaged over `iters` encodings (nothing is launched).
extern "C" double voxe_flash_attn_encode_us(const void* q, const void* k, const void* v, void* o, int B, int H,
                                            int Lq, int Lk, int D, int iters) {
  Maps m;
  if (!make_maps(&m, q, k, v, o, B, H, Lq, Lk, D)) return -1.0;  // also resolves the entry point
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) make_maps(&m, q, k, v, o, B, H, Lq, Lk, D);
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
