// The wide-head flash tile body for Hopper: every flash kernel above the
// register body's head dims of 128 runs on it.  Kernel 1 (non-causal
// attention with a natural-log LSE, optional kv_lens; flash_fwd_wide_kernel
// up to d = 512, flash_fwd_wide_split_kernel above, both in
// csrc/flash_wide.cu), kernel 4 (banded, BAND: flash_window_wide_kernel in
// csrc/flash_attn.cu) and kernels 7 and 8's flash partial (one ring hop
// folded into the fp32 (m, l, acc) state, CARRY: ring_flash_hop_wide_kernel
// in csrc/ring_flash.cu).  The SD-VAE's mid-block attention (B1 H1 S4096
// d512, kernel 1) is the shape on the path; no model path runs the others.
//
// Replaces: compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse,
// main branch (pallas_call at flash_pallas.py:593) and window= branch
// (:508), and compactfusion_tpu/ops/ring_flash_pallas.py::
// ring_flash_attn_with_lse (:347) and compact_binary_ring_flash's flash
// partial (:954), at the wide heads.  The Pallas kernels take any head dim;
// this body takes d <= kWidePart * kWideMaxParts (2048).
//
// What bounds it on an H100: operations.  At B1 H1 S4096 d512 the two
// products are 4 * S^2 * D = 34.4 GFLOP, 34.7 us at 989 TFLOP/s bf16,
// against 16.8 MB of q/k/v/out (5.0 us at 3.35 TB/s).  Every CTA streams
// all of K/V (8 MB) from L2, so the L2 traffic is CTAs x 8 MB.
//
// Design: flash_reg.cuh's register body with the head dim split across
// warps, and above d = 512 across the CTAs of a cluster.  A register
// accumulator of 16 rows x 512 fp32 would take 256 registers a thread, so:
//  * the padded head dim of a CTA, DP, is cut into NSL slices of DS <= 128
//    columns (ops/flash.py::flash_plan picks DP; NSL = ceil(DP / 128)).  A
//    CTA holds 2 row groups of 16 query rows x NSL slices, one warp each:
//    warp (r, s) keeps O[16 rows of r, slice s] as mma.sync.m16n8k16 fp32
//    fragments (64 registers a thread at DS 128) and Q[rows, slice s] as A
//    fragments loaded once;
//  * per K/V tile of kWideBK keys, warp (r, s) computes the partial scores
//    Q[:, s] K[:, s]^T over its slice alone; the NSL partials of a row group
//    meet in a shared-memory exchange (16 x kWideBK fp32 per warp, stored as
//    each thread's fragments, so no bank conflict) behind a named barrier
//    of the group's warps, and every warp adds them in slice order 0..NSL-1:
//    the warps of a group hold the same scores bit for bit, run the same
//    online softmax (flash_reg.cuh's: two rows a thread, quad shuffles, exp2
//    against the running max) and keep the same P as bf16 A fragments, then
//    add P V[:, slice s] into their own O.  QK^T is computed once, and O, P
//    and the softmax state never leave registers.  The exchange buffer is
//    rewritten only after the next tile's __syncthreads, by which every warp
//    has read it;
//  * K/V tiles of kWideBK = 32 keys (a 64-key K+V tile is 133 KB at DP 512)
//    stream through a cp.async ring of 2 or 3 stages, as many as fit beside
//    the Q tile and the exchange in 227 KB; rows past kv_len and columns
//    past D are zero-filled by the copy, rows are DP + 8 elements (an odd
//    number of 16-byte segments: ldmatrix without bank conflicts), and
//    q/k/v are read through their (b, s, h) strides.
// A row with no key writes 0 and LSE -inf.
//
// SPLIT (every kernel but kernel 1 up to d = 512): one CTA can hold at most
// kWidePart (512) columns of the head dim (Q, the K/V ring and the
// accumulators fit 227 KB and the register file no further), so a wider
// head takes a cluster of parts = ceil(d / 512) CTAs (at most kWideMaxParts)
// on the same query rows, CTA p holding columns [p DP, (p + 1) DP) of q, k,
// v and out: each is the CTA above on its columns.  Each CTA adds its
// slices' partials as above; slice 0 of each row group then publishes the
// CTA's sum in its shared memory, one cluster barrier (barrier.cluster) per
// tile, and every warp reads the sums of every CTA of the cluster (mapa,
// ld.shared::cluster, all of a CTA's in flight together) and adds them in
// CTA order, so all warps of the cluster hold the same scores bit for bit.
// The sums are double-buffered by the parity of the tile: a CTA writes tile
// t + 1's while a slower peer may still read tile t's, and it rewrites tile
// t's buffer only after the barrier of tile t + 1, which that peer reaches
// after its reads.  A last cluster barrier keeps every CTA resident until
// its peers are done with its sums.  At parts = 1 (kernels 4 and 7 up to
// d = 512) there is no cluster barrier.  Where a ring of 2 stages lets two
// CTAs share an SM (DP 288 and below in bf16, 256 in fp32), SPLIT takes 2:
// with 4 warps a CTA, one CTA per SM left each SM sub-partition one warp to
// issue from.
//
// BAND (kernel 4; self-attention, Sq == kv_len): keys with |i - j| > window
// are left out.  The K/V loop visits only the tiles that the band of the
// CTA's rows touches, from that of max(0, q0 - window) to that of
// min(S - 1, q0 + BQ - 1 + window); a tile is masked only where it is not
// wholly inside the band of every row of the group, and a group whose 16
// rows have no key in a visited tile skips its products there (on a
// cluster of more CTAs it still takes the barriers).  A row may have no key in the first tiles it
// visits (w=4; w=0): its max stays -inf and the exponents are taken against
// 0, as for a row with no key yet.
//
// CARRY (kernels 7 and 8): the state (m, l, O) of the tile starts from
// (after the first hop) and ends in (before the last) device memory, as in
// flash_reg.cuh: every warp reads the rows' m and l and its own columns of
// acc, and slice 0 of part 0 writes m and l back.
//
// fp32 (the *_f32_kernel instantiations) runs flash_reg.cuh's 3xTF32
// products (fp32_scores, fp32_pv; Q read from shared memory at every tile)
// on the same plans.  Its rows are DP + 4 floats, and a 32-key K+V tile
// would be 132 KB at DP 512, so its tiles hold 16 keys: at DP 512 the Q
// tile (66,048 bytes), two stages of K and V (132,096) and the exchange
// (8,192; 12,288 with SPLIT's sums) come to 206,336 bytes (210,432);
// three stages do not fit.
#pragma once

#include "flash_reg.cuh"

namespace {

constexpr int kWideBK = 32;  // keys per bf16 K/V tile
constexpr int kWidePart = 512;   // widest padded head dim one CTA holds
constexpr int kWideMaxParts = 4;  // CTAs of a cluster, at most

// The (DP, warps) pairs the wide kernels are built for, DP a CTA's part of
// the padded head dim: what ops/flash.py::flash_plan can choose (WIDE_BUILT
// there).  DP is NSL slices of DS columns, and warps = 2 row groups x NSL.
// Kernel 1 up to d = 512 and kernels 4 and 7 at every width take them all
#define CF_WIDE_PLANS(X) X(160, 4) X(192, 4) X(256, 4) X(288, 6) X(384, 6) X(512, 8)
// ... and kernel 1 above d = 512, split over a cluster, these
// (WIDE_SPLIT_BUILT)
#define CF_WIDE_SPLIT_PLANS(X) X(288, 6) X(384, 6) X(512, 8)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared memory of one CTA for ELEM-byte elements (ops/flash.py::
// wide_layout mirrors it): the Q tile, the K/V ring and the exchange (with
// SPLIT also two buffers of the row groups' sums); tiles of kWideBK keys in
// bf16, half as many in fp32.  The ring takes 3 stages where they fit, but
// with SPLIT 2 where that lets two CTAs share an SM's 228 KB (the system
// keeps 1 KB of it per CTA)
template <int DP, int NWARPS, int ELEM = 2, bool SPLIT = false>
struct WideLayout {
  static constexpr int kSlices = cdiv(DP, 128);
  static constexpr int kDs = DP / kSlices;
  static constexpr int kGroups = NWARPS / kSlices;
  static constexpr int kBK = kWideBK * 2 / ELEM;
  static constexpr int kLd = DP + 16 / ELEM;
  static constexpr int kQBytes = 16 * kGroups * kLd * ELEM;
  static constexpr int kTileBytes = kBK * kLd * ELEM;
  static constexpr int kXchBytes = NWARPS * 16 * kBK * 4 + SPLIT * 2 * kGroups * 16 * kBK * 4;
  static constexpr bool kTwoCtas = SPLIT && 2 * (kQBytes + 2 * 2 * kTileBytes + kXchBytes + 1024) <= 228 * 1024;
  static constexpr int kStages = 2 + (!kTwoCtas && kQBytes + 3 * 2 * kTileBytes + kXchBytes <= 227 * 1024);
  static constexpr int kBytes = kQBytes + kStages * 2 * kTileBytes + kXchBytes;
};

// Barrier `id` (1..15) of `threads` threads: the warps of one row group
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This CTA's rank in its cluster, and the cluster's CTAs
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster: the shared-memory writes before it are seen
// by the reads after it, in every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at `p` (this CTA's shared memory) in CTA `rank` of the cluster
__device__ __forceinline__ float4 ld_cluster(const float4* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}

// The query tile [q0, q0 + 16 kGroups) of head h, batch b against the keys
// [0, kv_len) in tiles of L::kBK; with SPLIT on this CTA's part of the head
// dim (the note above).  BAND takes `window`, CARRY `carry`.
template <typename T, int DP, int NWARPS, bool BAND = false, bool CARRY = false, bool SPLIT = false>
__device__ __forceinline__ void
flash_wide_tile(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Strides sq,
                Strides sk, Strides sv, T* __restrict__ out, float* __restrict__ lse, int kv_len,
                int H, int Sq, int D, float scale_log2, int q0, int h, int b, Carry carry = Carry{},
                int window = 0) {
  constexpr bool kF32 = sizeof(T) == 4;
  using Ops = MmaOps<T>;
  using L = WideLayout<DP, NWARPS, static_cast<int>(sizeof(T)), SPLIT>;
  constexpr int BK = L::kBK, NSL = L::kSlices, DS = L::kDs, BQ = 16 * L::kGroups;
  constexpr int NT = 32 * NWARPS, LD = L::kLd, STAGES = L::kStages;
  constexpr int NS = BK / 8;        // score fragments (8 keys each) per row strip
  constexpr int NO = DS / 8;        // accumulator fragments (8 columns each) of the slice
  constexpr int KQ = DS / Ops::kK;  // mma steps over the slice
  static_assert(NSL > 1 && DS * NSL == DP && DS % 16 == 0 && DS <= 128, "slices of 16..128 columns");
  static_assert(L::kGroups * NSL == NWARPS, "warps = row groups x slices");
  static_assert(L::kBytes <= 227 * 1024, "the layout must fit one CTA's shared memory");
  static_assert(!(BAND && CARRY) && (SPLIT || !(BAND || CARRY)), "kernel 4 bands, kernels 7 and 8 carry");
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::kQBytes);  // stage s: K at 2s, V at 2s + 1
  float4* xch = reinterpret_cast<float4*>(smem + L::kQBytes + STAGES * 2 * L::kTileBytes);
  float4* xsum = xch + NWARPS * NS * 32;  // SPLIT: [tile parity][group] sums of the CTA's slices

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // the mma layout: row group, thread in group
  const int grp = warp / NSL, sl = warp % NSL;
  const int r0 = grp * 16, c0 = sl * DS;  // this warp's rows and columns within the tile
  const int rowA = q0 + r0 + g, rowB = rowA + 8;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
  const T* qbh = q + b * sq.b + h * sq.h;
  const T* kbh = k + b * sk.b + h * sk.h;
  const T* vbh = v + b * sv.b + h * sv.h;
  // SPLIT: this CTA, part `part` of the cluster's `parts`, holds the columns
  // [cp, cp + DP) of the head dim, dl of them below D
  int part = 0, parts = 1, cp = 0, dl = D;
  if constexpr (SPLIT) {
    part = cluster_rank();
    parts = cluster_size();
    cp = part * DP;
    dl = min(D - cp, DP);
    qbh += cp;
    kbh += cp;
    vbh += cp;
    out += cp;
  }
  int t_lo = 0, t_end = (kv_len + BK - 1) / BK;
  if constexpr (BAND) {  // the K/V tiles the band of rows [q0, q0 + BQ) touches
    t_lo = max(0, q0 - window) / BK;
    t_end = min(kv_len - 1, q0 + BQ - 1 + window) / BK + 1;
  }

  auto load_kv = [&](int t) {
    T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    async_tile<T, BK, DP, LD, NT>(Ks, kbh, sk.s, t * BK, kv_len, dl, tid);
    async_tile<T, BK, DP, LD, NT>(Ks + BK * LD, vbh, sv.s, t * BK, kv_len, dl, tid);
  };
  // group 0: Q and tile t_lo; group s: tile t_lo + s
  async_tile<T, BQ, DP, LD, NT>(Qs, qbh, sq.s, q0, Sq, dl, tid);
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
  if constexpr (CARRY) {
    if (!carry.first) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = c0 + n * 8 + tig * 2;
        if (c < dl && rowA < Sq) {
          const float2 x = *reinterpret_cast<const float2*>(carry.acc + (row0 + rowA) * D + cp + c);
          o[n][0] = x.x;
          o[n][1] = x.y;
        }
        if (c < dl && rowB < Sq) {
          const float2 x = *reinterpret_cast<const float2*>(carry.acc + (row0 + rowB) * D + cp + c);
          o[n][2] = x.x;
          o[n][3] = x.y;
        }
      }
      if (rowA < Sq) {
        mA = carry.m[row0 + rowA];
        if (tig == 0) lA = carry.l[row0 + rowA];  // one part per quad
      }
      if (rowB < Sq) {
        mB = carry.m[row0 + rowB];
        if (tig == 0) lB = carry.l[row0 + rowB];
      }
    }
  }
  unsigned qf[kF32 ? 1 : KQ][4];  // bf16: Q's A fragments of the slice
  const T* qw = Qs + (r0 + (lane % 16)) * LD + c0 + (lane / 16) * 8;
  float4* xmine = xch + warp * NS * 32 + lane;          // this warp's partial scores
  const float4* xgrp = xch + grp * NSL * NS * 32 + lane;  // the group's, slice by slice

  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BK;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t (and Q) landed
    __syncthreads();  // everyone's landed; everyone is done with tile t - 1 and the exchange
    if (t + STAGES - 1 < t_end) load_kv(t + STAGES - 1);  // into tile t - 1's buffer
    cp_async_commit();
    const T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;
    if constexpr (!kF32) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], qw + kk * 16);
      }
    }
    // BAND: whether the group's rows [w0, w0 + 16) have no key in the tile,
    // and whether the tile lies wholly inside every one of their bands
    bool skip = false, band_ragged = false;
    if constexpr (BAND) {
      const int w0 = q0 + r0;
      skip = k0 > w0 + 15 + window || k0 + BK - 1 < w0 - window;
      band_ragged = w0 + 15 - k0 > window || k0 + BK - 1 - w0 > window || k0 + BK > kv_len;
    }

    // partial scores of this warp's 16 rows over its slice: fp32 fragments
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (!skip) {
      if constexpr (kF32) {
        fp32_scores<NS, KQ>(s, reinterpret_cast<const float*>(Qs), reinterpret_cast<const float*>(Ks), r0,
                            c0, LD, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {  // keys [16 np, 16 np + 16)
            unsigned kf[4];
            ldmatrix_x4(kf, Ks + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + c0 + kk * 16 +
                                ((lane / 8) % 2) * 8);
            Ops::mma(s[2 * np], qf[kk], kf[0], kf[1]);
            Ops::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
          }
        }
      }
    }

    // the group's full scores: the slices' partials added in slice order
    // (SPLIT on a cluster of more than one CTA: then the CTAs' sums, in
    // CTA order, through the buffer of the tile's parity)
    if constexpr (SPLIT) {
      if (skip && parts == 1) continue;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) xmine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    bar_sync(1 + grp, 32 * NSL);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float4 x = xgrp[n * 32];
#pragma unroll
      for (int j = 1; j < NSL; ++j) {
        const float4 y = xgrp[(j * NS + n) * 32];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      s[n][0] = x.x;
      s[n][1] = x.y;
      s[n][2] = x.z;
      s[n][3] = x.w;
    }
    if constexpr (SPLIT) {
      if (parts > 1) {
        // slice 0 of each group publishes the CTA's sum; every warp adds
        // the parts' sums in part order
        float4* xs = xsum + ((t & 1) * L::kGroups + grp) * NS * 32 + lane;
        if (sl == 0) {
#pragma unroll
          for (int n = 0; n < NS; ++n) xs[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        }
        cluster_sync();
        if (skip) continue;
        float4 x[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) x[n] = ld_cluster(xs + n * 32, 0);
        for (int p = 1; p < parts; ++p) {
          float4 y[NS];
#pragma unroll
          for (int n = 0; n < NS; ++n) y[n] = ld_cluster(xs + n * 32, p);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            x[n].x += y[n].x;
            x[n].y += y[n].y;
            x[n].z += y[n].z;
            x[n].w += y[n].w;
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[n][0] = x[n].x;
          s[n][1] = x[n].y;
          s[n][2] = x[n].z;
          s[n][3] = x[n].w;
        }
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
        float x = s[n][i] * scale_log2;
        if constexpr (BAND) {
          const int col = k0 + n * 8 + tig * 2 + (i % 2);
          if (band_ragged && (col >= kv_len || abs((i < 2 ? rowA : rowB) - col) > window)) x = -CUDART_INF_F;
        } else {
          if (ragged && k0 + n * 8 + tig * 2 + (i % 2) >= kv_len) x = -CUDART_INF_F;
        }
        s[n][i] = x;
      }
      xA = fmaxf(xA, fmaxf(s[n][0], s[n][1]));
      xB = fmaxf(xB, fmaxf(s[n][2], s[n][3]));
    }
    xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 1));
    xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, 2));
    xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 1));
    xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, 2));
    const float mA_new = fmaxf(mA, xA), mB_new = fmaxf(mB, xB);
    // a row with no key yet keeps m = -inf: take its exponents against 0
    const float refA = mA_new == -CUDART_INF_F ? 0.f : mA_new;
    const float refB = mB_new == -CUDART_INF_F ? 0.f : mB_new;
    const float alphaA = exp2f(mA - refA), alphaB = exp2f(mB - refB);  // 0 while m was -inf
    mA = mA_new;
    mB = mB_new;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = exp2f(s[n][i] - (i < 2 ? refA : refB));
      sumA += s[n][0] + s[n][1];
      sumB += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alphaA;
      o[n][1] *= alphaA;
      o[n][2] *= alphaB;
      o[n][3] *= alphaB;
    }
    lA = lA * alphaA + sumA;
    lB = lB * alphaB + sumB;

    // O[:, slice] += P V[:, slice]: P's A fragments straight from the scores
    if constexpr (kF32) {
      fp32_pv<NS, NO>(o, s, reinterpret_cast<const float*>(Vs), c0, LD, lane);
    } else {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // keys [16 kk, 16 kk + 16)
      unsigned pf[4];
      pf[0] = Ops::pack(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = Ops::pack(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = Ops::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = Ops::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {  // columns c0 + [16 dp, 16 dp + 16)
        unsigned vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane % 16)) * LD + c0 + dp * 16 + (lane / 16) * 8);
        Ops::mma(o[2 * dp], pf, vf[0], vf[1]);
        Ops::mma(o[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if constexpr (SPLIT) {
    if (parts > 1) cluster_sync();  // no CTA leaves while a peer reads its sums
  }

  // the whole row sums: the quad's parts
  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);

  if constexpr (CARRY) {
    if (!carry.last) {  // hand this warp's columns of the rows to the next hop
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = c0 + n * 8 + tig * 2;
        if (c >= dl) continue;
        if (rowA < Sq) {
          *reinterpret_cast<float2*>(carry.acc + (row0 + rowA) * D + cp + c) = make_float2(o[n][0], o[n][1]);
        }
        if (rowB < Sq) {
          *reinterpret_cast<float2*>(carry.acc + (row0 + rowB) * D + cp + c) = make_float2(o[n][2], o[n][3]);
        }
      }
      if (sl == 0 && part == 0 && tig == 0) {
        if (rowA < Sq) {
          carry.m[row0 + rowA] = mA;
          carry.l[row0 + rowA] = lA;
        }
        if (rowB < Sq) {
          carry.m[row0 + rowB] = mB;
          carry.l[row0 + rowB] = lB;
        }
      }
      return;
    }
  }

  // normalise and write this warp's columns: out (B, Sq, H, D); slice 0
  // (of part 0) writes lse (B, H, Sq)
  const float invA = lA > 0.f ? 1.f / lA : 0.f, invB = lB > 0.f ? 1.f / lB : 0.f;
  T* outA = out + ((static_cast<long long>(b) * Sq + rowA) * H + h) * D;
  T* outB = out + ((static_cast<long long>(b) * Sq + rowB) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = c0 + n * 8 + tig * 2;
    if (c >= dl) continue;
    if (rowA < Sq) Ops::store2(outA + c, o[n][0] * invA, o[n][1] * invA);
    if (rowB < Sq) Ops::store2(outB + c, o[n][2] * invB, o[n][3] * invB);
  }
  if (sl == 0 && tig == 0 && part == 0) {
    if (rowA < Sq) lse[row0 + rowA] = lA > 0.f ? (mA + log2f(lA)) * kLn2 : -CUDART_INF_F;
    if (rowB < Sq) lse[row0 + rowB] = lB > 0.f ? (mB + log2f(lB)) * kLn2 : -CUDART_INF_F;
  }
}

// The parts of a split plan of padded head dim `dp` (each CTA's is dp /
// parts, at most kWidePart), or 0 where dp is no such plan
__host__ __device__ inline int wide_parts(int dp) {
  const int parts = cdiv(dp, kWidePart);
  return parts <= kWideMaxParts && dp % parts == 0 ? parts : 0;
}

// Launch `kern` on (q tiles x parts, H, B) CTAs of `threads` threads and
// `bytes` of shared memory in clusters of `parts` CTAs along x
template <typename... Params, typename... Args>
int launch_split(void (*kern)(Params...), int parts, dim3 grid, int threads, int bytes, cudaStream_t stream,
                 Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x * parts, grid.y, grid.z);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// flash_fwd_wide_kernel's (f32: flash_fwd_wide_f32_kernel's) launch at the
// plan (dp, warps), in flash_wide.cu: q/k/v strides (b, s, h) in elements,
// the softmax scale times log2(e)
extern "C" int cf_flash_wide_launch(const void* q, const void* k, const void* v, long long qsb,
                                    long long qss, long long qsh, long long ksb, long long kss,
                                    long long ksh, long long vsb, long long vss, long long vsh,
                                    void* out, void* lse, const void* kv_lens, int B, int Sq,
                                    int Sk, int H, int D, float scale_log2, int dp, int warps,
                                    int f32, void* stream);
