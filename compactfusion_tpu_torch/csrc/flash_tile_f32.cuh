// The fp32 counterpart of flash_common.cuh::flash_tile: the shared-memory
// tile body on fp32 q/k/v, its products in 3xTF32 (flash_reg.cuh's note,
// MmaOps<float>).  It serves what the register and wide bodies leave on
// fp32: kernel 1 above d = 512 (flash_fwd_f32_kernel), kernel 4 above
// d = 128 (flash_window_f32_kernel) and kernels 7 and 8's flash partial
// above d = 128 (ring_flash_hop_f32_kernel).  No model path runs these
// shapes; the body completes the contract of the Pallas kernels, which take
// any input dtype at any head dim.
//
// Replaces: compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse
// (pallas_call at :593, and its window= branch at :508) and
// compactfusion_tpu/ops/ring_flash_pallas.py::ring_flash_attn_with_lse
// (:347) and compact_binary_ring_flash's flash partial (:954), on fp32
// inputs above the widths of the register and wide bodies.
//
// What bounds it on an H100: operations.  At d = 1024 the two products are
// 4 * Sq * Sk * d per head, and 3xTF32 issues three TF32 products for each:
// the bound of the design is 3x the work over 495 TFLOP/s TF32, against
// 67 TFLOP/s for plain fp32 on the CUDA cores.  This first body is simple
// and far from either: it restages Q from L2 for every K/V tile.
//
// Design, against the trap of the width: at d = 1024 in fp32 one 16-row Q
// tile, 16-key K and V tiles and a 16-row accumulator already take 256 KB,
// past the 227 KB a CTA may hold.  So
//  * the head dim streams through shared memory in slices of kTileF32Slice
//    (64) columns: the scores of a K/V tile accumulate in registers over
//    the slices of Q and K (each slice staged, then its 3xTF32 products),
//    and the PV product runs slice by slice of V and of the accumulator;
//  * the accumulator O (BQ x DP fp32) is the one full-width buffer in
//    shared memory, beside the slices and the probabilities: at 2 warps
//    (32 query rows, 32-key tiles) the layout is 163,584 bytes at d = 1024
//    and fits up to DP 1552 (bf16's flash_tile fits up to DP 688); at 4
//    warps (64 rows, 64-key tiles, kernels 4 and 7 up to DP 256) 138,752
//    bytes at DP 256 (ops/flash.py::tile_layout mirrors make_layout_f32);
//  * warp w owns rows [16w, 16w + 16): its scores are fp32 mma fragments
//    (rows g and g + 8 of the quad layout), the online softmax runs on them
//    in registers (the row max and sum over the quad by two shuffles), the
//    probabilities go to shared memory as the A operand of PV, and O is
//    rescaled by alpha as each slice of it is read for its product;
//  * rows of the Q and K slices are 68 floats and of the V slice 72, so the
//    fragment loads fall in 32 different banks; keys at or past kv_len and
//    columns at or past d are zero-filled by the copy; BAND, CARRY and the
//    -inf guard of a row with no key yet are flash_tile's.
#pragma once

#include "flash_reg.cuh"

namespace {

constexpr int kTileF32Slice = 64;  // head-dim columns per staged slice

// Shared-memory layout of the fp32 body, computed the same way on the host
// (to size the launch) and on the device
struct LayoutF32 {
  int dp;                       // head dim padded to a multiple of 16
  int ld_q, ld_k, ld_v, ld_p, ld_o;  // row strides, floats
  int off_q, off_k, off_v, off_p, off_o, off_m, off_l;
  int bytes;
};

__host__ __device__ inline LayoutF32 make_layout_f32(int d, int bq, int bk) {
  LayoutF32 L;
  L.dp = round_up(d, 16);
  L.ld_q = kTileF32Slice + 4;
  L.ld_k = kTileF32Slice + 4;
  L.ld_v = kTileF32Slice + 8;
  L.ld_p = bk + 4;
  L.ld_o = L.dp + 8;
  int off = 0;
  L.off_q = off; off = align128(off + bq * L.ld_q * 4);
  L.off_k = off; off = align128(off + bk * L.ld_k * 4);
  L.off_v = off; off = align128(off + bk * L.ld_v * 4);
  L.off_p = off; off = align128(off + bq * L.ld_p * 4);
  L.off_o = off; off = align128(off + bq * L.ld_o * 4);
  L.off_m = off; off = align128(off + bq * 4);
  L.off_l = off; off = align128(off + bq * 4);
  L.bytes = off;
  return L;
}

// Columns [c0, c0 + w) of rows [row0, row0 + nrows) of one (b, h) slice
// into a shared tile, 4 floats (16 bytes) per access; rows at or past
// valid_rows and columns at or past d are zeros.  Needs d % 4 == 0, a
// 16-byte aligned source and a row stride that is a multiple of 4.
__device__ inline void load_slice_f32(float* dst, int ld, const float* src, long long stride_s, int row0,
                                      int nrows, int valid_rows, int c0, int w, int d, int tid, int nt) {
  const int chunks = w / 4;
  for (int idx = tid; idx < nrows * chunks; idx += nt) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < valid_rows && c0 + c < d) {
      val = *reinterpret_cast<const float4*>(src + row * stride_s + c0 + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// The tile body on fp32: the arguments and contract of flash_tile.
template <int NWARPS, int BK, bool BAND, bool CARRY>
__device__ __forceinline__ void
flash_tile_f32(const float* __restrict__ q, const float* k, const float* v, Strides sq, Strides sk,
               Strides sv, float* __restrict__ out, float* __restrict__ lse, int kv_len, int H, int Sq,
               int Sk, int D, float scale_log2, int window, int q0, int h, int b, Carry carry) {
  static_assert(BK % 8 == 0, "keys in steps of 8");
  using Ops = MmaOps<float>;
  constexpr int BQ = 16 * NWARPS;
  constexpr int NT = 32 * NWARPS;
  constexpr int NB = BK / 8;  // score fragments (8 keys each) per row strip
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L = make_layout_f32(D, BQ, BK);
  float* Qs = reinterpret_cast<float*>(smem + L.off_q);
  float* Ks = reinterpret_cast<float*>(smem + L.off_k);
  float* Vs = reinterpret_cast<float*>(smem + L.off_v);
  float* Ps = reinterpret_cast<float*>(smem + L.off_p);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);
  float* row_m = reinterpret_cast<float*>(smem + L.off_m);
  float* row_l = reinterpret_cast<float*>(smem + L.off_l);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16;  // this warp's rows within the tile
  const long long state_row0 = (static_cast<long long>(b) * H + h) * Sq;  // carry index of row 0

  const float* qbh = q + b * sq.b + h * sq.h;
  const float* kbh = k + b * sk.b + h * sk.h;
  const float* vbh = v + b * sv.b + h * sv.h;

  const bool resume = CARRY && !carry.first;
  for (int i = tid; i < BQ * L.dp; i += NT) {
    const int r = i / L.dp, c = i % L.dp, row = q0 + r;
    Os[r * L.ld_o + c] = (resume && row < Sq && c < D) ? carry.acc[(state_row0 + row) * D + c] : 0.f;
  }
  // the running max and sum of this thread's rows r0 + g and r0 + g + 8
  float m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool live = resume && row < Sq;
    m_run[i] = live ? carry.m[state_row0 + row] : -CUDART_INF_F;
    l_run[i] = live ? carry.l[state_row0 + row] : 0.f;
  }
  __syncthreads();  // O is whole before any warp reads its rows

  int t_lo = 0, t_end = (kv_len + BK - 1) / BK;
  if (BAND) {  // the KV tiles that the band of rows [q0, q0 + BQ) touches
    t_lo = max(0, q0 - window) / BK;
    t_end = min(Sk - 1, q0 + BQ - 1 + window) / BK + 1;
  }
  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BK;
    // scores of this warp's 16 rows over the head-dim slices
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c0 = 0; c0 < L.dp; c0 += kTileF32Slice) {
      const int w = min(kTileF32Slice, L.dp - c0);
      __syncthreads();  // every warp is done with the previous slices
      load_slice_f32(Qs, L.ld_q, qbh, sq.s, q0, BQ, Sq, c0, w, D, tid, NT);
      load_slice_f32(Ks, L.ld_k, kbh, sk.s, k0, BK, kv_len, c0, w, D, tid, NT);
      __syncthreads();
      for (int kk = 0; kk < w; kk += 8) {
        const float* qa = Qs + (r0 + g) * L.ld_q + kk + t4;
        unsigned ah[4], al[4];
        Ops::split(qa[0], ah[0], al[0]);
        Ops::split(qa[8 * L.ld_q], ah[1], al[1]);
        Ops::split(qa[4], ah[2], al[2]);
        Ops::split(qa[8 * L.ld_q + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float* kb = Ks + (n * 8 + g) * L.ld_k + kk + t4;
          unsigned bh0, bl0, bh1, bl1;
          Ops::split(kb[0], bh0, bl0);
          Ops::split(kb[4], bh1, bl1);
          Ops::mma(s[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }

    // online softmax of rows g (i = 0) and g + 8 (i = 1) of the strip: a
    // thread holds keys 8n + 2 t4 and 8n + 2 t4 + 1 of each; the exponent
    // is taken against 0 while a row has no key (m -inf)
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = k0 + n * 8 + 2 * t4 + j;
          bool keep = col < kv_len;
          if (BAND) keep = keep && abs(row - col) <= window;
          const float x = keep ? s[n][2 * i + j] * scale_log2 : -CUDART_INF_F;
          s[n][2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_ref = m_new == -CUDART_INF_F ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float p0 = exp2f(s[n][2 * i] - m_ref), p1 = exp2f(s[n][2 * i + 1] - m_ref);
        *reinterpret_cast<float2*>(Ps + (r0 + g + 8 * i) * L.ld_p + n * 8 + 2 * t4) = make_float2(p0, p1);
        sum += p0 + p1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[i] = exp2f(m_run[i] - m_ref);  // 0 while m_run is -inf
      m_run[i] = m_new;
      l_run[i] = l_run[i] * alpha[i] + sum;
    }
    __syncwarp();

    // O = alpha O + P V, slice by slice of V and of this warp's rows of O
    for (int c0 = 0; c0 < L.dp; c0 += kTileF32Slice) {
      const int w = min(kTileF32Slice, L.dp - c0);
      __syncthreads();  // every warp is done with the previous V slice
      load_slice_f32(Vs, L.ld_v, vbh, sv.s, k0, BK, kv_len, c0, w, D, tid, NT);
      __syncthreads();
      for (int n0 = 0; n0 < w; n0 += 8) {
        float* o0 = Os + (r0 + g) * L.ld_o + c0 + n0 + 2 * t4;
        float* o1 = o0 + 8 * L.ld_o;
        float acc[4] = {o0[0] * alpha[0], o0[1] * alpha[0], o1[0] * alpha[1], o1[1] * alpha[1]};
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
          const float* pa = Ps + (r0 + g) * L.ld_p + kk + t4;
          unsigned ah[4], al[4];
          Ops::split(pa[0], ah[0], al[0]);
          Ops::split(pa[8 * L.ld_p], ah[1], al[1]);
          Ops::split(pa[4], ah[2], al[2]);
          Ops::split(pa[8 * L.ld_p + 4], ah[3], al[3]);
          const float* vb = Vs + (kk + t4) * L.ld_v + n0 + g;
          unsigned bh0, bl0, bh1, bl1;
          Ops::split(vb[0], bh0, bl0);
          Ops::split(vb[4 * L.ld_v], bh1, bl1);
          Ops::mma(acc, ah, al, bh0, bh1, bl0, bl1);
        }
        o0[0] = acc[0];
        o0[1] = acc[1];
        o1[0] = acc[2];
        o1[1] = acc[3];
      }
    }
  }

  // the rows' state, for the lanes that write them
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_m[r0 + g + 8 * i] = m_run[i];
      row_l[r0 + g + 8 * i] = l_run[i];
    }
  }
  __syncwarp();
  if (CARRY && !carry.last) {  // hand this warp's rows to the next hop
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
      if (row >= Sq) break;
      float* arow = carry.acc + (state_row0 + row) * D;
      for (int c = lane; c < D; c += 32) arow[c] = Os[r * L.ld_o + c];
      if (lane == 0) {
        carry.m[state_row0 + row] = row_m[r];
        carry.l[state_row0 + row] = row_l[r];
      }
    }
    return;
  }
  // normalise and write this warp's rows: out (B, Sq, H, D), lse (B, H, Sq)
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= Sq) break;
    const float l = row_l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = Os[r * L.ld_o + c] * inv;
    if (lane == 0) {
      lse[state_row0 + row] = l > 0.f ? (row_m[r] + log2f(l)) * kLn2 : -CUDART_INF_F;
    }
  }
}

}  // namespace
