// The flash attention tile body shared by csrc/flash_attn.cu (full and
// banded attention) and csrc/ring_flash.cu (the ring kernels): bf16 in,
// fp32 math, a natural-log LSE.  See flash_attn.cu for the design.
//
// One call computes the query tile [q0, q0 + 16 * NWARPS) of head h, batch
// b against every K/V tile.  With CARRY the online-softmax state (m, l, acc)
// of the tile starts from and ends in device memory instead of fresh
// registers/shared memory, so a ring folds one hop per launch into it:
// first = no state yet, last = normalise and write out/LSE.
//
// Kernels 1, 4 and 7 up to a head dim of 128, kernel 8's flash partial and
// the stage probe run on the register body of flash_reg.cuh, and kernel 1
// up to 512 (the VAE's d=512) on the wide body of flash_wide.cuh.  This
// body serves what is left, which no path of the pipeline runs: kernel 1
// above d = 512, and kernels 4 and 7 above d = 128; on fp32 inputs its
// counterpart is flash_tile_f32.cuh's.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // in elements; the head-dim stride is 1
};

// The running softmax state of a ring: m and l (B, H, Sq) in the exp2
// domain of scaled scores, acc (B, H, Sq, D), all fp32.
struct Carry {
  float* m;
  float* l;
  float* acc;
  int first, last;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Shared-memory layout, computed the same way on the host (to size the
// launch) and on the device.  Row strides carry padding against bank
// conflicts while keeping every WMMA tile pointer 32-byte aligned.
struct Layout {
  int dp;     // head dim padded to a multiple of 16
  int ld_in;  // q/k/v tile row stride, bf16 elements
  int ld_s;   // score tile row stride, floats
  int ld_p;   // probability tile row stride, bf16 elements
  int ld_o;   // accumulator row stride, floats
  int off_q, off_k, off_v, off_s, off_p, off_o, off_m, off_l, off_a;
  int bytes;
};

__host__ __device__ inline Layout make_layout(int d, int bq, int bk) {
  Layout L;
  L.dp = round_up(d, 16);
  L.ld_in = L.dp + 8;
  L.ld_s = bk + 4;
  L.ld_p = bk + 8;
  L.ld_o = L.dp + 4;
  int off = 0;
  L.off_q = off; off = align128(off + bq * L.ld_in * 2);
  L.off_k = off; off = align128(off + bk * L.ld_in * 2);
  L.off_v = off; off = align128(off + bk * L.ld_in * 2);
  L.off_s = off; off = align128(off + bq * L.ld_s * 4);
  L.off_p = off; off = align128(off + bq * L.ld_p * 2);
  L.off_o = off; off = align128(off + bq * L.ld_o * 4);
  L.off_m = off; off = align128(off + bq * 4);
  L.off_l = off; off = align128(off + bq * 4);
  L.off_a = off; off = align128(off + bq * 4);
  L.bytes = off;
  return L;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + nrows) of one (b, h) slice into a shared tile,
// 8 bf16 (16 bytes) per access.  Rows at or past valid_rows and the padded
// columns [d, dp) are written as zeros.  Needs d % 8 == 0, a 16-byte
// aligned source and a row stride that is a multiple of 8.
__device__ inline void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                 long long stride_s, int row0, int nrows, int valid_rows,
                                 int d, int dp, int tid, int nt) {
  const int chunks = dp / 8;
  for (int idx = tid; idx < nrows * chunks; idx += nt) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid_rows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + row * stride_s + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The tile body.  BAND: keys outside |i - j| <= window are masked and the
// KV tiles wholly outside the band of this q-tile are not visited (then
// Sq == Sk and kv_len == Sk).  Keys at or past kv_len are masked.
template <int NWARPS, int BK, bool BAND, bool CARRY>
__device__ __forceinline__ void
flash_tile(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           Strides sq, Strides sk, Strides sv, __nv_bfloat16* __restrict__ out,
           float* __restrict__ lse, int kv_len, int H, int Sq, int Sk, int D, float scale_log2,
           int window, int q0, int h, int b, Carry carry) {
  constexpr int BQ = 16 * NWARPS;
  constexpr int NT = 32 * NWARPS;
  constexpr int PER_LANE = BK / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(D, BQ, BK);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.off_k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);
  float* row_m = reinterpret_cast<float*>(smem + L.off_m);
  float* row_l = reinterpret_cast<float*>(smem + L.off_l);
  float* row_a = reinterpret_cast<float*>(smem + L.off_a);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long state_row0 = (static_cast<long long>(b) * H + h) * Sq;  // carry index of row 0

  const __nv_bfloat16* qbh = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kbh = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vbh = v + b * sv.b + h * sv.h;

  load_tile(Qs, L.ld_in, qbh, sq.s, q0, BQ, Sq, D, L.dp, tid, NT);
  if (CARRY && !carry.first) {
    for (int i = tid; i < BQ * L.dp; i += NT) {
      const int r = i / L.dp, c = i % L.dp, row = q0 + r;
      Os[r * L.ld_o + c] = (row < Sq && c < D) ? carry.acc[(state_row0 + row) * D + c] : 0.f;
    }
    for (int i = tid; i < BQ; i += NT) {
      const bool live = q0 + i < Sq;
      row_m[i] = live ? carry.m[state_row0 + q0 + i] : -CUDART_INF_F;
      row_l[i] = live ? carry.l[state_row0 + q0 + i] : 0.f;
    }
  } else {
    for (int i = tid; i < BQ * L.dp; i += NT) Os[(i / L.dp) * L.ld_o + i % L.dp] = 0.f;
    for (int i = tid; i < BQ; i += NT) {
      row_m[i] = -CUDART_INF_F;
      row_l[i] = 0.f;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;  // this warp's rows within the tile
  int t_lo = 0, t_end = (kv_len + BK - 1) / BK;
  if (BAND) {  // the KV tiles that the band of rows [q0, q0 + BQ) touches
    t_lo = max(0, q0 - window) / BK;
    t_end = min(Sk - 1, q0 + BQ - 1 + window) / BK + 1;
  }
  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(Ks, L.ld_in, kbh, sk.s, k0, BK, kv_len, D, L.dp, tid, NT);
    load_tile(Vs, L.ld_in, vbh, sv.s, k0, BK, kv_len, D, L.dp, tid, NT);
    __syncthreads();

    // scores of this warp's 16 rows: Q[r0:r0+16] @ K^T -> Ss (fp32)
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < L.dp / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + r0 * L.ld_in + kk * 16, L.ld_in);
        wmma::load_matrix_sync(fb, Ks + n * 16 * L.ld_in + kk * 16, L.ld_in);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * L.ld_s + n * 16, acc, L.ld_s, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of the same rows.  Without a band every visited tile
    // holds a valid key (k0 < kv_len); with one, a row may have none yet, so
    // m_new may be -inf: the exponents are then taken against 0 (p = 0 and
    // alpha = 0 while the row has no key) instead of giving NaN
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
      float s[PER_LANE];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int col = k0 + lane + 32 * j;
        bool keep = col < kv_len;
        if (BAND) keep = keep && abs(row - col) <= window;
        s[j] = keep ? Ss[r * L.ld_s + lane + 32 * j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_ref = m_new == -CUDART_INF_F ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const float p = exp2f(s[j] - m_ref);
        Ps[r * L.ld_p + lane + 32 * j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_ref);  // 0 while m_old is -inf
        row_a[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncwarp();

    // rescale this warp's accumulator rows, then O += P @ V
    for (int i = lane; i < 16 * L.dp; i += 32) {
      const int r = r0 + i / L.dp;
      Os[r * L.ld_o + i % L.dp] *= row_a[r];
    }
    __syncwarp();
    for (int n = 0; n < L.dp / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * L.ld_o + n * 16, L.ld_o, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + r0 * L.ld_p + kk * 16, L.ld_p);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * L.ld_in + n * 16, L.ld_in);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + r0 * L.ld_o + n * 16, acc, L.ld_o, wmma::mem_row_major);
    }
    __syncwarp();
  }

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
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(Os[r * L.ld_o + c] * inv);
    if (lane == 0) {
      lse[state_row0 + row] = l > 0.f ? (row_m[r] + log2f(l)) * kLn2 : -CUDART_INF_F;
    }
  }
}

}  // namespace
