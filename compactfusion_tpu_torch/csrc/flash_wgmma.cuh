// The wgmma flash tile body for Hopper: kernel 1 (non-causal attention with
// a natural-log LSE; csrc/flash_wgmma.cu, flash_fwd_wgmma_kernel) and
// kernel 7 (one ring hop folded into the fp32 (m, l, acc) state;
// ring_flash_hop_wgmma_kernel), and with it the flash partial of kernel 8,
// on bf16 q/k/v at padded head dims 64, 80, 96 and 128.  Kernel 4 (banded),
// fp32 and the stage probe keep flash_reg.cuh's register body, and heads
// above 128 flash_wide.cuh's body; ops/flash.py::flash_plan says which.
//
// Replaces: compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse, main
// branch (pallas_call at flash_pallas.py:593), and compactfusion_tpu/ops/
// ring_flash_pallas.py::ring_flash_attn_with_lse (pallas_call at
// ring_flash_pallas.py:347) and compact_binary_ring_flash's flash partial
// (:954).
//
// What bounds it on an H100: operations.  The two products are 4 * S_q *
// S_k * D per head (FLUX's B1 H24 S4608 d128: 261 GFLOP, 0.264 ms at 989
// TFLOP/s bf16) against 4 * S * D * 2 bytes of q/k/v/out (0.032 ms at 3.35
// TB/s); and each score takes one exp2 on the SFU (16 a clock per SM), which
// at d 64 costs about as much as the products.
//
// Design (the register body's design is for mma.sync; this one is for
// Hopper's wgmma and TMA):
//  * a CTA is one producer warpgroup and one or two consumer warpgroups (64-
//    or 128-row query tiles); the producer gives its registers to the
//    consumers (setmaxnreg) and one of its threads issues every copy: the Q
//    tile once, then K and V tiles of kWgBK keys into a ring of kStages
//    stages, each a TMA load (cp.async.bulk.tensor, 4-D tensor maps over
//    the (D, S, H, B) view through its byte strides) that completes on the
//    stage's full mbarrier; consumers free a stage on its empty mbarrier
//    once the products that read it have retired (wgmma.wait_group);
//  * S = Q K^T is one chain of wgmma.m64n128k16 per consumer warpgroup with
//    Q and K from shared memory (K-major); O += P V one chain of
//    wgmma.m64nDPk16 with P from registers and V from shared memory
//    (MN-major, the transpose bit);
//  * shared-memory tiles are column blocks of 64 columns (128-byte
//    swizzle) and, at DP 80 and 96, one tail block of 16 (32-byte swizzle)
//    or 32 columns (64-byte), each loaded through a tensor map of its own
//    box and swizzle, so d 72 and 88 are padded to 80 and 96, not 128; the
//    descriptors step through the blocks, and at DP 80 and 96 O += P V is
//    one product for the 64 columns and one for the tail;
//  * tile it's S is issued together with tile it - 1's P V, and tile it's
//    softmax runs while that product does (O takes tile it - 1's product,
//    then tile it's rescale: the order of one tile at a time); two consumer
//    warpgroups take turns to issue their products (named barriers), so one
//    warpgroup's softmax overlaps the other's products;
//  * the online softmax runs on the accumulator fragments in registers, as
//    the register body's does: a thread holds two rows, the row max is
//    taken across its quad, P goes from the score fragments to bf16 A
//    fragments with no shuffle, exp2 of the scores scaled by scale * log2e
//    (one FFMA each) against the running max (0 while a row has no key
//    yet) on ex2.approx.ftz;
//  * columns D..DP-1 and rows past S come in as TMA's zeros; keys at or
//    past kv_len are set to -inf in the scores.
// A row's result depends on its own q row and the K/V only (the key tiles
// and the order of every sum are fixed), not on the tile height or grid.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)

#include "flash_reg.cuh"

namespace {

constexpr int kWgBK = 128;  // keys per K/V tile

// The (DP, consumer warps) pairs the wgmma kernels are built for: what
// ops/flash.py::flash_plan can choose (WG_BUILT there)
#define CF_WG_PLANS(X) X(64, 4) X(64, 8) X(80, 4) X(80, 8) X(96, 4) X(96, 8) X(128, 4) X(128, 8)

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int csel(bool c, int a, int b) { return c ? a : b; }

// The shared memory of one CTA (ops/flash.py::wgmma_layout mirrors it): the
// Q tile, kStages stages of a K and a V tile, each kWide blocks of 64
// columns and a tail block of kTail (0, 16 or 32), then the barriers, from a
// 1024-byte aligned base.  The ring takes up to 4 stages; one consumer
// warpgroup keeps room for two CTAs an SM where two of 2 stages fit.
template <int DP, int NWARPS>
struct WgLayout {
  static constexpr int kWide = DP / 64;  // 64-column blocks
  static constexpr int kTail = DP % 64;  // the tail block's columns
  static constexpr int kGroups = NWARPS / 4;  // consumer warpgroups
  static constexpr int kQBytes = 16 * NWARPS * DP * 2;
  static constexpr int kTileBytes = kWgBK * DP * 2;  // one K or V tile
  static constexpr int kFixed = kQBytes + 1024 + 256;  // Q, the alignment slack, the barriers
  static constexpr bool kTwoCtas = kGroups == 1 && 2 * (kFixed + 2 * 2 * kTileBytes + 1024) <= 228 * 1024;
  static constexpr int kRoom = csel(kTwoCtas, 228 * 1024 / 2 - 1024, 227 * 1024);
  static constexpr int kStages = cmin(4, (kRoom - kFixed) / (2 * kTileBytes));
  static constexpr int kBytes = kFixed + kStages * 2 * kTileBytes;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the 4-D tensor map at (column, row, head, batch) into shared
// memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// no read or write of the registers moves across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// named barrier `id` (1..15; 0 is __syncthreads') of `count` threads: wait
// at it, or arrive and go on
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x on the SFU, subnormal results flushed to 0: one MUFU.EX2, where
// exp2f's handling of subnormals adds instructions to every score (a p or
// alpha below 2^-126 beside a row max's 1 changes no sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A wgmma shared-memory descriptor of a swizzled block of ATOM-column rows
// (ATOM 64, 32 or 16: a swizzle of 128, 64 or 32 bytes, its code 1, 2 or
// 3): start address, leading and stride byte offsets (in 16-byte units).
// K-major (Q, K): the stride offset steps 8 rows, the leading one is
// unused.  MN-major (V): the stride offset steps 8 keys, the leading one
// the next 64-column block.
template <int ATOM>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lead_bytes) {
  constexpr uint64_t swizzle = ATOM == 64 ? 1 : ATOM == 32 ? 2 : 3;
  constexpr uint32_t stride_bytes = 8 * ATOM * 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (swizzle << 62);
}

// wgmma.m64nNk16 bf16 -> fp32 for one warpgroup, its accumulator N / 2
// floats a thread in the layout of mma.m16n8's C fragments, one per 8
// columns, a warp per 16 rows
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[OFF, OFF + 8) += A (64 x 16, bf16 fragments in registers) * B (16 x 16, MN-major, descriptor b)
  template <int OFF, int M>
  static __device__ __forceinline__ void rs(float (&d)[M], const unsigned (&a)[4], uint64_t b) {
    static_assert(OFF + 8 <= M, "the accumulator holds the product's columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d[OFF, OFF + 16) += A (64 x 16, bf16 fragments in registers) * B (16 x 32, MN-major, descriptor b)
  template <int OFF, int M>
  static __device__ __forceinline__ void rs(float (&d)[M], const unsigned (&a)[4], uint64_t b) {
    static_assert(OFF + 16 <= M, "the accumulator holds the product's columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d[OFF, OFF + 32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64, MN-major, descriptor b)
  template <int OFF, int M>
  static __device__ __forceinline__ void rs(float (&d)[M], const unsigned (&a)[4], uint64_t b) {
    static_assert(OFF + 32 <= M, "the accumulator holds the product's columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A (64 x 16, K-major, descriptor a) * B (128 x 16, K-major, descriptor b)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d[OFF, OFF + 64) += A (64 x 16, bf16 fragments in registers) * B (16 x 128, MN-major, descriptor b)
  template <int OFF, int M>
  static __device__ __forceinline__ void rs(float (&d)[M], const unsigned (&a)[4], uint64_t b) {
    static_assert(OFF + 64 <= M, "the accumulator holds the product's columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


// The tile body: query rows [q0, q0 + 16 NWARPS) of head h, batch b
// against keys [0, kv_len) in tiles of kWgBK, from the tensor maps of q
// (boxes of 64 columns x 16 NWARPS rows; tq[1] of the tail's columns), k
// and v (64 x kWgBK; tk[1], tv[1] the tail's).  CARRY:
// the state (m, l, O) of the rows starts from (after the first hop) and
// ends in (before the last) device memory (Carry).  A row with no key
// writes 0 and LSE -inf.
template <int DP, int NWARPS, bool CARRY>
__device__ __forceinline__ void
flash_wgmma_tile(const CUtensorMap* const (&tq)[2], const CUtensorMap* const (&tk)[2],
                 const CUtensorMap* const (&tv)[2], __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int kv_len, int H, int Sq, int D, float scale_log2, int q0, int h, int b,
                 Carry carry) {
  static_assert(DP % 16 == 0 && DP <= 128 && (NWARPS == 4 || NWARPS == 8), "64- or 128-row tiles up to DP 128");
  using L = WgLayout<DP, NWARPS>;
  using Ops = MmaOps<__nv_bfloat16>;
  constexpr int BK = kWgBK, BQ = 16 * NWARPS, WIDE = L::kWide, TAIL = L::kTail, ST = L::kStages, NG = L::kGroups;
  constexpr int NS = BK / 8;  // score fragments (8 keys each) a row pair
  constexpr int NO = DP / 8;  // accumulator fragments (8 columns each)
  static_assert(TAIL == 0 || WIDE == 1, "a tail only beside one 64-column block");
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, ring = base + L::kQBytes, bars = ring + ST * 2 * L::kTileBytes;
  // barriers: Q full; per stage K full, V full, K empty, V empty
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + ST + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * ST + s); };
  const int n_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NG);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4 * NG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NG) {  // the producer warpgroup: one thread issues every copy
    regs_down<24>();
    if (threadIdx.x % 128 == 0) {
      // the blocks of a tile of `rows` rows at `dst`: 64 columns each, then the tail
      auto load_tile = [&](uint32_t dst, const CUtensorMap* const (&maps)[2], uint32_t bar, int rows, int row0) {
#pragma unroll
        for (int a = 0; a < WIDE; ++a) tma_load(dst + a * rows * 128, maps[0], bar, a * 64, row0, h, b);
        if constexpr (TAIL > 0) tma_load(dst + WIDE * rows * 128, maps[1], bar, WIDE * 64, row0, h, b);
      };
      mbar_expect_tx(q_full, L::kQBytes);
      load_tile(sQ, tq, q_full, BQ, q0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, ph = (it / ST) & 1;
        const uint32_t ks = ring + s * 2 * L::kTileBytes, vs = ks + L::kTileBytes;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), L::kTileBytes);
        load_tile(ks, tk, k_full(s), BK, it * BK);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        load_tile(vs, tv, v_full(s), BK, it * BK);
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    regs_up<NG == 2 ? 240 : 232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tig = lane % 4;  // the fragment layout: row group, thread in group
    const int rowA = q0 + wg * 64 + warp * 16 + g, rowB = rowA + 8;  // this thread's two rows
    const long long state_row0 = (static_cast<long long>(b) * H + h) * Sq;

    // the state of rows A (o[4n], o[4n + 1]) and B (o[4n + 2], o[4n + 3])
    float o[DP / 2];
    float mA = -CUDART_INF_F, mB = -CUDART_INF_F, lA = 0.f, lB = 0.f;  // l: this thread's part
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    if (CARRY && !carry.first) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + tig * 2;
        if (c < D && rowA < Sq) {
          const float2 x = *reinterpret_cast<const float2*>(carry.acc + (state_row0 + rowA) * D + c);
          o[4 * n] = x.x;
          o[4 * n + 1] = x.y;
        }
        if (c < D && rowB < Sq) {
          const float2 x = *reinterpret_cast<const float2*>(carry.acc + (state_row0 + rowB) * D + c);
          o[4 * n + 2] = x.x;
          o[4 * n + 3] = x.y;
        }
      }
      if (rowA < Sq) {
        mA = carry.m[state_row0 + rowA];
        if (tig == 0) lA = carry.l[state_row0 + rowA];  // one part per quad
      }
      if (rowB < Sq) {
        mB = carry.m[state_row0 + rowB];
        if (tig == 0) lB = carry.l[state_row0 + rowB];
      }
    }


    auto stage = [&](int it) { return ring + (it % ST) * 2 * L::kTileBytes; };
    auto phase = [&](int it) { return (it / ST) & 1; };
    // S = Q K^T of tile it over DP / 16 steps of the head dim (this
    // warpgroup's 64 rows of each Q block), issued
    auto issue_scores = [&](int it, float (&sc)[BK / 2]) {
      const uint32_t ks = stage(it);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk < 4 * WIDE) {
          const uint32_t off = (kk % 4) * 32, q_blk = sQ + (kk / 4) * BQ * 128 + wg * 64 * 128;
          Wgmma<BK>::ss(sc, wg_desc<64>(q_blk + off, 16), wg_desc<64>(ks + (kk / 4) * BK * 128 + off, 16), kk > 0);
        } else if constexpr (TAIL > 0) {
          const uint32_t off = (kk - 4 * WIDE) * 32, q_blk = sQ + WIDE * BQ * 128 + wg * 64 * TAIL * 2;
          Wgmma<BK>::ss(sc, wg_desc<TAIL>(q_blk + off, 16), wg_desc<TAIL>(ks + WIDE * BK * 128 + off, 16), 1);
        }
      }
    };
    // O += P V of tile it over BK / 16 steps of the keys, issued: one
    // product over every 64-column block (the leading offset steps from one
    // to the next), and one over the tail
    auto issue_pv = [&](int it, const unsigned (&pf)[BK / 16][4]) {
      const uint32_t vs = stage(it) + L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        Wgmma<64 * WIDE>::template rs<0>(o, pf[kk], wg_desc<64>(vs + kk * 16 * 128, BK * 128));
        if constexpr (TAIL > 0) {
          Wgmma<TAIL>::template rs<32 * WIDE>(o, pf[kk], wg_desc<TAIL>(vs + WIDE * BK * 128 + kk * 16 * TAIL * 2, 16));
        }
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the online softmax of tile it's scores, in place: keys at or past
    // kv_len masked (only the last tile has any), the running max of the two
    // rows across the quad, p = exp2 of the scaled scores against it, l
    // updated; returns O's rescale factors of rows A and B
    auto softmax = [&](int it, float (&sc)[BK / 2]) {
      const int k0 = it * BK;
      const bool ragged = k0 + BK > kv_len;
      float xA = -CUDART_INF_F, xB = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (ragged) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (k0 + n * 8 + tig * 2 + (i % 2) >= kv_len) sc[4 * n + i] = -CUDART_INF_F;
          }
        }
        xA = fmaxf(xA, fmaxf(sc[4 * n], sc[4 * n + 1]));
        xB = fmaxf(xB, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
      // the max of the scaled scores is the scaled max (scale > 0), rounded
      // up: each p below is exp2 of one FFMA, s * scale_log2 - m, unrounded
      // in between, which a max rounded to nearest could exceed by half an
      // ulp of m, and exp2 of that overflows where scores reach 2^24 or so;
      // above a max rounded up every exponent is <= 0
      const float mA_new = fmaxf(mA, __fmul_ru(xA, scale_log2)), mB_new = fmaxf(mB, __fmul_ru(xB, scale_log2));
      // a row with no key yet keeps m = -inf: take its exponents against 0
      const float refA = mA_new == -CUDART_INF_F ? 0.f : mA_new;
      const float refB = mB_new == -CUDART_INF_F ? 0.f : mB_new;
      const float2 alpha = make_float2(ex2(mA - refA), ex2(mB - refB));  // 0 while m was -inf
      mA = mA_new;
      mB = mB_new;
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], scale_log2, -refA));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], scale_log2, -refA));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], scale_log2, -refB));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], scale_log2, -refB));
        sumA += sc[4 * n] + sc[4 * n + 1];
        sumB += sc[4 * n + 2] + sc[4 * n + 3];
      }
      lA = lA * alpha.x + sumA;
      lB = lB * alpha.y + sumB;
      return alpha;
    };
    // O rescaled, then P's A fragments straight from the score fragments:
    // keys [16 kk, 16 kk + 16)
    auto rescale_and_pack = [&](float2 alpha, const float (&sc)[BK / 2], unsigned (&pf)[BK / 16][4]) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[4 * n] *= alpha.x;
        o[4 * n + 1] *= alpha.x;
        o[4 * n + 2] *= alpha.y;
        o[4 * n + 3] *= alpha.y;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = Ops::pack(sc[8 * kk], sc[8 * kk + 1]);
        pf[kk][1] = Ops::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = Ops::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = Ops::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // Two consumer warpgroups take turns to issue their products (named
    // barriers 1 and 2: warpgroup w waits at 1 + w, then lets the other go),
    // so one's softmax runs while the other's products do
    auto my_turn = [&] {
      if constexpr (NG == 2) bar_sync(1 + wg, 256);
    };
    auto your_turn = [&] {
      if constexpr (NG == 2) bar_arrive(2 - wg, 256);
    };
    if (NG == 2 && wg == 1) bar_arrive(1, 256);  // warpgroup 0 goes first

    // Tile it's scores are computed while tile it - 1's P V runs on the
    // tensor cores, and its softmax overlaps that product: O takes tile it
    // - 1's product, then tile it's rescale, in the order of one tile at a
    // time
    float sc[BK / 2];
    unsigned pf[BK / 16][4];
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      mbar_wait(k_full(0), 0);
      my_turn();
      wg_fence();
      issue_scores(0, sc);
      wg_commit();
      your_turn();
      wg_wait<0>();
      fence_regs(sc);
      release(k_empty(0));
      rescale_and_pack(softmax(0, sc), sc, pf);
    }
    for (int it = 1; it < n_tiles; ++it) {
      mbar_wait(k_full(it % ST), phase(it));
      mbar_wait(v_full((it - 1) % ST), phase(it - 1));
      my_turn();
      wg_fence();
      issue_scores(it, sc);
      wg_commit();
      issue_pv(it - 1, pf);
      wg_commit();
      your_turn();
      wg_wait<1>();  // the scores; tile it - 1's product may still run
      fence_regs(sc);
      release(k_empty(it % ST));
      const float2 alpha = softmax(it, sc);
      wg_wait<0>();
      fence_regs(o);
      release(v_empty((it - 1) % ST));
      rescale_and_pack(alpha, sc, pf);
    }
    if (n_tiles > 0) {
      mbar_wait(v_full((n_tiles - 1) % ST), phase(n_tiles - 1));
      my_turn();
      wg_fence();
      issue_pv(n_tiles - 1, pf);
      wg_commit();
      your_turn();
      wg_wait<0>();
      fence_regs(o);
      release(v_empty((n_tiles - 1) % ST));
    }

    // the whole row sums: the quad's parts
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);

    if (CARRY && !carry.last) {  // hand this thread's rows to the next hop
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + tig * 2;
        if (c >= D) continue;
        if (rowA < Sq) {
          *reinterpret_cast<float2*>(carry.acc + (state_row0 + rowA) * D + c) = make_float2(o[4 * n], o[4 * n + 1]);
        }
        if (rowB < Sq) {
          *reinterpret_cast<float2*>(carry.acc + (state_row0 + rowB) * D + c) =
              make_float2(o[4 * n + 2], o[4 * n + 3]);
        }
      }
      if (tig == 0 && rowA < Sq) {
        carry.m[state_row0 + rowA] = mA;
        carry.l[state_row0 + rowA] = lA;
      }
      if (tig == 0 && rowB < Sq) {
        carry.m[state_row0 + rowB] = mB;
        carry.l[state_row0 + rowB] = lB;
      }
      return;
    }
    // normalise and write: out (B, Sq, H, D), lse (B, H, Sq)
    const float invA = lA > 0.f ? 1.f / lA : 0.f, invB = lB > 0.f ? 1.f / lB : 0.f;
    __nv_bfloat16* outA = out + ((static_cast<long long>(b) * Sq + rowA) * H + h) * D;
    __nv_bfloat16* outB = out + ((static_cast<long long>(b) * Sq + rowB) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tig * 2;
      if (c >= D) continue;
      if (rowA < Sq) Ops::store2(outA + c, o[4 * n] * invA, o[4 * n + 1] * invA);
      if (rowB < Sq) Ops::store2(outB + c, o[4 * n + 2] * invB, o[4 * n + 3] * invB);
    }
    if (tig == 0) {
      if (rowA < Sq) lse[state_row0 + rowA] = lA > 0.f ? (mA + log2f(lA)) * kLn2 : -CUDART_INF_F;
      if (rowB < Sq) lse[state_row0 + rowB] = lB > 0.f ? (mB + log2f(lB)) * kLn2 : -CUDART_INF_F;
    }
  }
}

}  // namespace
