// The register-resident flash tile body (mma.sync, cp.async), head dims up
// to 128 (wider heads take flash_wide.cuh, this body split over warps).
// Which launches take it (ops/flash.py::flash_plan): kernel 4 (banded:
// BAND) always; kernels 1 (non-causal attention with a natural-log LSE;
// csrc/flash_attn.cu) and 7 (one ring hop folded into an fp32 (m, l, acc)
// state; csrc/ring_flash.cu), and with 7 the flash partial of kernel 8, on
// fp32 q/k/v, and on bf16 only for a launch with no key (their other bf16
// launches take flash_wgmma.cuh's wgmma body); and the stage probe of
// kernel 1 (csrc/probes.cu), which a tool may hold against kernel 1 on
// this body's plan (flash_attn_with_lse's plan argument).
//
// Replaces: compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse,
// main branch (pallas_call at flash_pallas.py:593) and window= branch
// (:508), and compactfusion_tpu/ops/ring_flash_pallas.py::
// ring_flash_attn_with_lse (pallas_call at ring_flash_pallas.py:347).
//
// What bounds it on an H100: operations.  At B2 H16 S1024 d72 the two
// products are 4 * B * H * S^2 * D = 9.66 GFLOP, 9.77 us at 989 TFLOP/s
// bf16, against 19 MB of q/k/v/out (5.6 us at 3.35 TB/s).
//
// Design, against the three costs of a shared-memory body (WMMA scores,
// probabilities and accumulator staged in shared memory on every tile):
//  * the products never leave registers: warp w owns query rows
//    [16w, 16w + 16) of the tile; its scores S (16 x BK) and its
//    accumulator O (16 x DP) are fp32 fragments of
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, Q's A fragments are
//    loaded once by ldmatrix and kept for every K/V tile, K feeds QK^T by
//    ldmatrix and V feeds PV by ldmatrix.trans, and P goes from S's
//    accumulator fragments to bf16 A fragments in registers: no score,
//    probability or accumulator element goes to shared memory;
//  * the softmax is per thread: a thread holds two rows of its warp's 16
//    (groupID and groupID + 8 of the mma layout), takes their max across
//    its quad with two shuffles (xor 1 and 2), keeps m and a partial l in
//    registers (the quad's partials are summed once, at the end: alpha is
//    the same on the four threads of a row) and rescales its O fragments
//    in place; exp2 of scores scaled by scale * log2e, with the exponent
//    taken against 0 while a row has no key yet;
//  * K/V tiles stream through a ring of STAGES shared-memory buffers filled
//    by 16-byte cp.async.cg copies, one commit group per tile: tiles t + 1
//    (and t + 2) are in flight while tile t is computed, with one
//    __syncthreads per tile; rows at or past kv_len and the padded columns
//    [D, DP) are zero-filled by the copy itself (src-size 0).  q/k/v are
//    read through their (b, s, h) strides.  Rows are padded to DP + 8
//    elements, an odd number of 16-byte segments, so the 8 rows of every
//    ldmatrix phase fall in 8 different bank groups.
//
// The element type is a template parameter (MmaOps): bf16 as above, or
// fp32 (kernels 1, 4 and 7 on fp32 q/k/v, and kernel 8's flash partial on
// fp32 reconstructions).  fp32 runs the products in 3xTF32 on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), and a product is accumulated as
// lo.hi' + hi.lo' + hi.hi' in fp32, which leaves out lo.lo' and the rounding
// of lo (about 2^-21 relative), where one TF32 pass would put scores about
// 1e-3 off; each such triple goes into a zeroed fragment that fp32 adds
// then fold into the scores or the accumulator (MmaOps<float>::mma), so no
// truncating tensor-core accumulation runs longer than one triple.  What
// changes against bf16:
//  * rows are DP + 4 floats (16-byte aligned, an odd number of 16-byte
//    segments), so ldmatrix reads Q and K without bank conflicts: an 8 x 8
//    b16 matrix is 8 rows of 4 floats, and lane l gets row l / 4, word
//    l % 4, which is the tf32 A fragment of Q and the B fragment of K;
//  * Q is read from shared memory at every K/V tile (its hi and lo
//    fragments would take 128 registers a thread at DP 128);
//  * P's A fragments come from the score fragments with no shuffle, by
//    reordering the keys of each 8-key step: A column t is key 2t and
//    column t + 4 key 2t + 1, so a thread's two scores of a row (keys 2t,
//    2t + 1) are its own A elements; V's B fragment takes the same order,
//    V[2t][col] and V[2t + 1][col], by 32-bit shared loads (ldmatrix has no
//    .trans for 32-bit elements), which at a row stride of 4 or 20 mod 32
//    words fall in 32 different banks.
// PARTS switches stages off for the stage probe (bf16 only); every
// production kernel takes all stages, for which each switch compiles away.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // in elements; the head-dim stride is 1
};

// The running softmax state of a ring (CARRY, kernels 7 and 8): m and l
// (B, H, Sq) in the exp2 domain of scaled scores, acc (B, H, Sq, D), all
// fp32.  A body's state of its rows starts from and ends in it instead of
// fresh registers, so a ring folds one hop per launch into it: first = no
// state yet, last = normalise and write out/LSE.
struct Carry {
  float* m;
  float* l;
  float* acc;
  int first, last;
};

// The stages of the tile body.  Switched off, each computes what the
// doctored Pallas kernel of _prof_kernel_parts.py computes in its place:
//   kQK    the score product; off, every score of a row is q[row, 0]
//   kScale the softmax scale; off, the exponent takes log2e alone
//   kMax   the running max; off, m stays 0 and alpha 1
//   kExp   the exp2; off, p = score - running max (alpha 1)
//   kAV    the PV product and the row sum; off, the accumulator takes p of
//          the keys below D (columns = key index) and l the sum of keys
//          0-7, both rescaled by alpha
enum Part : int { kQK = 1, kScale = 2, kMax = 4, kExp = 8, kAV = 16 };
constexpr int kAllParts = kQK | kScale | kMax | kExp | kAV;

// A masked-in score of a probe: the product (or q[row, 0] without one)
// times the factor the switches leave
template <int PARTS>
__device__ __forceinline__ float probe_factor(float x, float scale_log2) {
  if constexpr ((PARTS & kScale) != 0) return x * scale_log2;
  else if constexpr ((PARTS & kExp) != 0) return x * kLog2e;
  else return x;
}

constexpr int kRegBK = 64;  // keys per K/V tile

// The bodies a plan names (ops/flash.py::BODIES); the wide body is
// flash_wide.cuh's
enum Body : int { kRegBody = 1, kWideBody = 2 };

// The (DP, warps) pairs the register kernels are built for: what
// ops/flash.py::flash_plan can choose (REG_BUILT there)
#define CF_REG_PLANS(X) \
  X(64, 2) X(64, 4) X(64, 8) X(80, 2) X(80, 4) X(80, 8) X(96, 2) X(96, 4) X(96, 8) \
  X(128, 2) X(128, 4) X(128, 8)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The tensor-core operations of one element type.  bf16: m16n8k16 with
// fp32 accumulators; fp32: 3xTF32 on m16n8k8 (the note above).
template <typename T>
struct MmaOps;

template <>
struct MmaOps<__nv_bfloat16> {
  static constexpr int kK = 16;  // depth of one mma
  // d += a (16 x 16, row) * b (16 x 8, col)
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two fp32 values rounded into one A-fragment register (lo in the low half)
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <>
struct MmaOps<float> {
  static constexpr int kK = 8;  // depth of one mma
  // x as hi = tf32(x) and lo = tf32(x - hi); x - hi is exact in fp32
  static __device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  }
  static __device__ __forceinline__ void split4(const unsigned (&x)[4], unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
  }
  // d += a (16 x 8, row) * b (8 x 8, col), one tf32 pass
  static __device__ __forceinline__ void mma1(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                              unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // d += a * b in 3xTF32, the small terms first (a_lo b_hi + a_hi b_lo +
  // a_hi b_hi) into a zeroed fragment, which is then added to d by fp32
  // adds that round to nearest: the tensor core's own accumulation
  // truncates, and chained over the hundreds of steps of a row its bias
  // grows with the number of keys (3.3e-5 relative at 4608 keys on an H100)
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&ahi)[4],
                                             const unsigned (&alo)[4], unsigned bhi0, unsigned bhi1,
                                             unsigned blo0, unsigned blo1) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma1(t, alo, bhi0, bhi1);
    mma1(t, ahi, blo0, blo1);
    mma1(t, ahi, bhi0, bhi1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
  }
  static __device__ __forceinline__ void store2(float* p, float lo, float hi) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
};

// The shared memory of one CTA for ELEM-byte elements (ops/flash.py::
// reg_layout mirrors it): rows of DP + 8 bf16 or DP + 4 fp32 elements, an
// odd number of 16-byte segments; the ring's depth is 3 stages where two
// CTAs of 3 stages still share an SM, else 2
template <int DP, int NWARPS, int ELEM = 2>
struct RegLayout {
  static constexpr int kLd = DP + 16 / ELEM;  // row stride in elements
  static constexpr int kQBytes = 16 * NWARPS * kLd * ELEM;
  static constexpr int kTileBytes = kRegBK * kLd * ELEM;  // one K or V tile
  static constexpr int kStages = 2 + (2 * (kQBytes + 3 * 2 * kTileBytes) <= 227 * 1024);
  static constexpr int kBytes = kQBytes + kStages * 2 * kTileBytes;
};

// Copy rows [row0, row0 + ROWS) of one (b, h) slice into a shared tile of
// row stride LD with cp.async, 16 bytes a copy; rows at or past valid_rows
// and columns at or past d are zero-filled.  Needs d % 8 == 0, 16-byte
// aligned rows.
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void async_tile(T* dst, const T* src, long long stride_s, int row0,
                                           int valid_rows, int d, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int kChunks = DP / kVec;
#pragma unroll
  for (int idx = tid; idx < ROWS * kChunks; idx += NT) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec, row = row0 + r;
    const bool live = row < valid_rows && c < d;
    cp_async16(dst + r * LD + c, live ? src + row * stride_s + c : src, live ? 16 : 0);
  }
}

// fp32 scores of one warp's 16 rows [r0, r0 + 16) against NS * 8 keys of
// a K tile, over the KQ 8-column steps of its columns [c0, c0 + 8 KQ), in
// 3xTF32: s[n] += Q[rows, c0:] K[8n .. 8n + 8, c0:]^T.  Q's A fragment
// (rows g, g + 8 at columns t, t + 4) and K's B fragments of two 8-key
// steps (key g at columns t, t + 4) are each one ldmatrix.x4 of 8 x 4-float
// matrices, split into hi and lo as they arrive.
template <int NS, int KQ>
__device__ __forceinline__ void fp32_scores(float (&s)[NS][4], const float* Qs, const float* Ks,
                                            int r0, int c0, int LD, int lane) {
  using Ops = MmaOps<float>;
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int c = c0 + kk * 8;
    unsigned qa[4], qh[4], ql[4];
    ldmatrix_x4(qa, Qs + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + c + (lane / 16) * 4);
    Ops::split4(qa, qh, ql);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {  // keys [16 np, 16 np + 16)
      unsigned kb[4], kh[4], kl[4];
      ldmatrix_x4(kb, Ks + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + c + ((lane / 8) % 2) * 4);
      Ops::split4(kb, kh, kl);
      Ops::mma(s[2 * np], qh, ql, kh[0], kh[1], kl[0], kl[1]);
      Ops::mma(s[2 * np + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
    }
  }
}

// O[:, c0 + 8n ..] += P V[:, c0 + 8n ..] for one warp in 3xTF32, P the
// probabilities in the score fragments s (NS steps of 8 keys).  Each 8-key
// step takes its keys in the order 0, 2, 4, 6 | 1, 3, 5, 7 (A column t is
// key 2t, t + 4 key 2t + 1), so a thread's A fragment is its own s[n][0, 2,
// 1, 3] and V's B fragment is V[2t][c], V[2t + 1][c] with c = c0 + 8n + g.
template <int NS, int NO>
__device__ __forceinline__ void fp32_pv(float (&o)[NO][4], const float (&s)[NS][4], const float* Vs,
                                        int c0, int LD, int lane) {
  using Ops = MmaOps<float>;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    unsigned pa[4], ph[4], pl[4];
    pa[0] = __float_as_uint(s[n][0]);
    pa[1] = __float_as_uint(s[n][2]);
    pa[2] = __float_as_uint(s[n][1]);
    pa[3] = __float_as_uint(s[n][3]);
    Ops::split4(pa, ph, pl);
    const float* v0 = Vs + (n * 8 + 2 * tig) * LD + c0 + g;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      unsigned bh0, bl0, bh1, bl1;
      Ops::split(v0[j * 8], bh0, bl0);
      Ops::split(v0[LD + j * 8], bh1, bl1);
      Ops::mma(o[j], ph, pl, bh0, bh1, bl0, bl1);
    }
  }
}

// The tile body: the query tile [q0, q0 + 16 * NWARPS) of head h, batch b
// against the keys [0, kv_len) in tiles of kRegBK.  CARRY: the state
// (m, l, O) of the tile starts from (after the first hop) and ends in
// (before the last) device memory (Carry).  A row with no key
// writes 0 and LSE -inf.  With a stage switched off (PARTS) the probe
// passes the factor of its scores as scale_log2: scale * log2e with the
// exponent, the plain scale without it.
//
// BAND (kernel 4; self-attention, Sq == kv_len): keys with |i - j| > window
// are left out.  The K/V loop visits only the tiles the band of the q-tile
// touches, from that of max(0, q0 - window) to that of min(S - 1, q0 + BQ -
// 1 + window), and the copy ring starts at the first of them; a tile is
// masked only where it is not wholly inside the band of every row of the
// warp (or holds keys at or past kv_len), and a warp whose 16 rows have no
// key in a visited tile skips its products there: that leaves its state as
// a wholly masked tile would.  A row may have no key in the first tiles it
// visits (w=4 at q0=64; w=0): its max stays -inf and the exponents are taken
// against 0, as for a row with no key yet.
template <typename T, int DP, int NWARPS, bool CARRY, int PARTS = kAllParts, bool BAND = false>
__device__ __forceinline__ void
flash_reg_tile(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Strides sq,
               Strides sk, Strides sv, T* __restrict__ out, float* __restrict__ lse, int kv_len,
               int H, int Sq, int D, float scale_log2, int q0, int h, int b, Carry carry,
               int window = 0) {
  static_assert(DP % 16 == 0 && DP <= 128, "the register body pads the head dim to 16..128");
  static_assert(PARTS == kAllParts || !CARRY, "stage switches are for full attention");
  static_assert(!BAND || (PARTS == kAllParts && !CARRY), "the band is kernel 4's alone");
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!kF32 || PARTS == kAllParts, "the stage probe is bf16's");
  using Ops = MmaOps<T>;
  using L = RegLayout<DP, NWARPS, static_cast<int>(sizeof(T))>;
  constexpr bool kAll = PARTS == kAllParts;
  constexpr bool kRescale = (PARTS & kMax) != 0 && (PARTS & kExp) != 0;
  constexpr int BK = kRegBK, BQ = 16 * NWARPS, NT = 32 * NWARPS, LD = L::kLd, STAGES = L::kStages;
  constexpr int NS = BK / 8;  // score fragments (8 keys each) per row strip
  constexpr int NO = DP / 8;  // accumulator fragments (8 columns each)
  constexpr int KQ = DP / Ops::kK;  // mma steps over the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::kQBytes);  // stage s: K at 2s, V at 2s + 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // the mma layout: row group, thread in group
  const int r0 = warp * 16;                // this warp's rows within the tile
  const int rowA = q0 + r0 + g, rowB = rowA + 8;  // this thread's two rows
  const long long state_row0 = (static_cast<long long>(b) * H + h) * Sq;
  const T* qbh = q + b * sq.b + h * sq.h;
  const T* kbh = k + b * sk.b + h * sk.h;
  const T* vbh = v + b * sv.b + h * sv.h;
  int t_lo = 0, t_end = (kv_len + BK - 1) / BK;
  if constexpr (BAND) {  // the K/V tiles the band of rows [q0, q0 + BQ) touches
    t_lo = max(0, q0 - window) / BK;
    t_end = min(kv_len - 1, q0 + BQ - 1 + window) / BK + 1;
  }

  auto load_kv = [&](int t) {
    T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    async_tile<T, BK, DP, LD, NT>(Ks, kbh, sk.s, t * BK, kv_len, D, tid);
    async_tile<T, BK, DP, LD, NT>(Ks + BK * LD, vbh, sv.s, t * BK, kv_len, D, tid);
  };
  // group 0: Q and tile t_lo; group s: tile t_lo + s
  async_tile<T, BQ, DP, LD, NT>(Qs, qbh, sq.s, q0, Sq, D, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_lo + s < t_end) load_kv(t_lo + s);
    cp_async_commit();
  }

  // the state of rows A (c[0], c[1] of a fragment) and B (c[2], c[3])
  float o[NO][4];
  float mA = -CUDART_INF_F, mB = -CUDART_INF_F, lA = 0.f, lB = 0.f;  // l: this thread's part
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (CARRY && !carry.first) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tig * 2;
      if (c < D && rowA < Sq) {
        const float2 x = *reinterpret_cast<const float2*>(carry.acc + (state_row0 + rowA) * D + c);
        o[n][0] = x.x;
        o[n][1] = x.y;
      }
      if (c < D && rowB < Sq) {
        const float2 x = *reinterpret_cast<const float2*>(carry.acc + (state_row0 + rowB) * D + c);
        o[n][2] = x.x;
        o[n][3] = x.y;
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

  unsigned qf[kF32 ? 1 : KQ][4];  // bf16: Q's A fragments, loaded at the first tile
  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BK;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t (and Q) landed
    __syncthreads();  // everyone's landed; everyone is done with tile t - 1's buffer
    if (t + STAGES - 1 < t_end) load_kv(t + STAGES - 1);  // into tile t - 1's buffer
    cp_async_commit();
    const T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;
    if constexpr (!kF32) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
          ldmatrix_x4(qf[kk], Qs + (r0 + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
        }
      }
    }
    // BAND: whether this warp's rows [w0, w0 + 16) have keys in the tile, and
    // whether the tile lies wholly inside every one of their bands
    bool band_ragged = false;
    if constexpr (BAND) {
      const int w0 = q0 + r0;
      if (k0 > w0 + 15 + window || k0 + BK - 1 < w0 - window) continue;  // no key: skip
      band_ragged = w0 + 15 - k0 > window || k0 + BK - 1 - w0 > window || k0 + BK > kv_len;
    }

    // scores of this warp's 16 rows: S = Q K^T, fp32 fragments
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kF32) {
      fp32_scores<NS, KQ>(s, reinterpret_cast<const float*>(Qs), reinterpret_cast<const float*>(Ks), r0,
                          0, LD, lane);
    } else if constexpr ((PARTS & kQK) != 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {  // keys [16 np, 16 np + 16)
          unsigned kf[4];
          ldmatrix_x4(kf, Ks + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                              ((lane / 8) % 2) * 8);
          Ops::mma(s[2 * np], qf[kk], kf[0], kf[1]);
          Ops::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
    } else {
      const float qa = Ops::to_float(Qs[(r0 + g) * LD]), qb = Ops::to_float(Qs[(r0 + g + 8) * LD]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = s[n][1] = qa;
        s[n][2] = s[n][3] = qb;
      }
    }

    // scale, mask the keys at or past kv_len (only the last tile has any)
    // and, with BAND, those off the band, and the running max of the two
    // rows across the quad
    const bool ragged = k0 + BK > kv_len;
    float xA = -CUDART_INF_F, xB = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x;
        if constexpr (kAll) x = s[n][i] * scale_log2;
        else x = probe_factor<PARTS>(s[n][i], scale_log2);
        if constexpr (BAND) {
          const int col = k0 + n * 8 + tig * 2 + (i % 2);
          if (band_ragged && (col >= kv_len || abs((i < 2 ? rowA : rowB) - col) > window)) {
            x = -CUDART_INF_F;
          }
        } else {
          if (ragged && k0 + n * 8 + tig * 2 + (i % 2) >= kv_len) x = -CUDART_INF_F;
        }
        s[n][i] = x;
      }
      xA = fmaxf(xA, fmaxf(s[n][0], s[n][1]));
      xB = fmaxf(xB, fmaxf(s[n][2], s[n][3]));
    }
    float mA_new = 0.f, mB_new = 0.f, refA = 0.f, refB = 0.f;
    if constexpr ((PARTS & kMax) != 0) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
      mA_new = fmaxf(mA, xA);
      mB_new = fmaxf(mB, xB);
      // a row with no key yet keeps m = -inf: take its exponents against 0
      refA = mA_new == -CUDART_INF_F ? 0.f : mA_new;
      refB = mB_new == -CUDART_INF_F ? 0.f : mB_new;
    }
    float alphaA = 1.f, alphaB = 1.f;
    if constexpr (kRescale) {
      alphaA = exp2f(mA - refA);  // 0 while m was -inf
      alphaB = exp2f(mB - refB);
    }
    mA = mA_new;
    mB = mB_new;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ref = i < 2 ? refA : refB;
        s[n][i] = (PARTS & kExp) != 0 ? exp2f(s[n][i] - ref) : s[n][i] - ref;
      }
      sumA += s[n][0] + s[n][1];
      sumB += s[n][2] + s[n][3];
    }
    if constexpr (kRescale) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alphaA;
        o[n][1] *= alphaA;
        o[n][2] *= alphaB;
        o[n][3] *= alphaB;
      }
    }

    if constexpr ((PARTS & kAV) != 0) {
      lA = lA * alphaA + sumA;
      lB = lB * alphaB + sumB;
      if constexpr (kF32) {
        fp32_pv<NS, NO>(o, s, reinterpret_cast<const float*>(Vs), 0, LD, lane);
      } else {
      // O += P V: P's A fragments straight from the score fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // keys [16 kk, 16 kk + 16)
        unsigned pf[4];
        pf[0] = Ops::pack(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = Ops::pack(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = Ops::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = Ops::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {  // columns [16 dp, 16 dp + 16)
          unsigned vf[4];
          ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane % 16)) * LD + dp * 16 + (lane / 16) * 8);
          Ops::mma(o[2 * dp], pf, vf[0], vf[1]);
          Ops::mma(o[2 * dp + 1], pf, vf[2], vf[3]);
        }
      }
      }
    } else {
      // no PV product: the accumulator's columns below D take p of the keys
      // of the same index, l the sum of keys 0-7
      if (k0 == 0) {
        lA = lA * alphaA + s[0][0] + s[0][1];
        lB = lB * alphaB + s[0][2] + s[0][3];
      } else {
        lA *= alphaA;
        lB *= alphaB;
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          if (n * 8 == k0 + j * 8 && n * 8 < D) {
#pragma unroll
            for (int i = 0; i < 4; ++i) o[n][i] = s[j][i];
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

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
        *reinterpret_cast<float2*>(carry.acc + (state_row0 + rowA) * D + c) = make_float2(o[n][0], o[n][1]);
      }
      if (rowB < Sq) {
        *reinterpret_cast<float2*>(carry.acc + (state_row0 + rowB) * D + c) = make_float2(o[n][2], o[n][3]);
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
  // normalise and write: out (B, Sq, H, D), lse (B, H, Sq).  A probe's l
  // may be negative or 0 (no exponent): it divides by l, or by 1 where l is
  // 0, and writes no LSE
  float invA, invB;
  if constexpr (kAll) {
    invA = lA > 0.f ? 1.f / lA : 0.f;
    invB = lB > 0.f ? 1.f / lB : 0.f;
  } else {
    invA = 1.f / (lA == 0.f ? 1.f : lA);
    invB = 1.f / (lB == 0.f ? 1.f : lB);
  }
  T* outA = out + ((static_cast<long long>(b) * Sq + rowA) * H + h) * D;
  T* outB = out + ((static_cast<long long>(b) * Sq + rowB) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (c >= D) continue;
    if (rowA < Sq) Ops::store2(outA + c, o[n][0] * invA, o[n][1] * invA);
    if (rowB < Sq) Ops::store2(outB + c, o[n][2] * invB, o[n][3] * invB);
  }
  if (kAll && tig == 0) {
    if (rowA < Sq) lse[state_row0 + rowA] = lA > 0.f ? (mA + log2f(lA)) * kLn2 : -CUDART_INF_F;
    if (rowB < Sq) lse[state_row0 + rowB] = lB > 0.f ? (mB + log2f(lB)) * kLn2 : -CUDART_INF_F;
  }
}

}  // namespace
