// Non-causal flash attention with a natural-log LSE, bf16 in, fp32 math:
// full attention (flash_fwd_kernel) and banded attention |i - j| <= w
// (flash_window_kernel), one tile layout and one body for both.
//
// Replaces: compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse, main
// branch (kernels _flash_kernel / _flash_kernel_heads, pallas_call at
// flash_pallas.py:593) and its window= branch (pallas_call at
// flash_pallas.py:508).
//
// What bounds it on an H100: at the PixArt shapes (d=72, Sq*Sk ~ 1e6 per
// head) attention does ~4*Sq*Sk*d FLOPs on ~8*S*d bytes, far above the
// card's ~295 FLOP/byte ridge, so it is bound by math: the bf16 tensor cores
// for the two products, and the fp32 CUDA cores for the exp2 of every score.
// The VAE mid-block shape (d=512, S=4096, one head) is the same, with a head
// dim too wide for a register-resident accumulator.
//
// Design (simple first, see ROADMAP for WGMMA/TMA):
//  * one CTA per (q-tile, head, batch); the TPU's sequential KV grid axis
//    becomes an in-block loop over K/V tiles staged in shared memory;
//  * warp w owns query rows [16w, 16w+16) of the tile end to end: its score
//    strip (WMMA 16x16x16 bf16 -> fp32), the online softmax of those rows
//    (fp32 m/l, exp2 domain), and its rows of the fp32 accumulator, so the
//    only block-wide barriers are around the K/V tile loads;
//  * the head dim is zero-padded to a multiple of 16 in shared memory
//    (d=72 -> 80), and q/k/v are read through their (b, s, h) strides, so
//    PixArt's column slices of one qkv tensor need no copy;
//  * the accumulator lives in dynamic shared memory, not registers, which is
//    what lets d=512 run: 64x64 tiles for d <= ~160, 32x32 tiles (2 warps)
//    above, with cudaFuncAttributeMaxDynamicSharedMemorySize raised past
//    48 KB;
//  * keys at or past min(kv_lens[b], Sk) are masked; tiles wholly past it
//    are skipped.  A row with no valid key writes 0 and LSE -inf, the
//    attn_with_lse convention.
//
// The banded kernel (DiTFastAttn's window attention; Sq == Sk, no kv_lens):
//  * off-band tiles are skipped, not masked: the q-tile at q0 visits only the
//    KV tiles from that of max(0, q0 - w) to that of min(S - 1, q0 + BQ - 1
//    + w), and masks |i - j| > w inside them, so the work scales with S * w
//    (at w=64, S=1024, 64x64 tiles an inner q-tile visits 3 of 16 KV tiles);
//  * a visited tile may hold no key of some row (w=4, q0=64: row 127 has
//    none in tile 0), so the running max can still be -inf after a tile and
//    the exponent is taken against 0 there instead of -inf - -inf = NaN;
//  * what bounds it: at B2 H16 S1024 d72, w=64 it must read q/k/v and write
//    out/LSE, ~19.0 MB (~5.7 us at 3.35 TB/s), against ~1.18 GFLOP of band
//    products (127,936 band pairs per head; ~1.2 us at 989 TFLOP/s): memory,
//    where the full kernel is bound by math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // in elements; the head-dim stride is 1
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

// The kernels' common body.  BAND: keys outside |i - j| <= window are masked
// and the KV tiles wholly outside the band of this q-tile are not visited
// (then Sq == Sk and kv_lens is null).
template <int NWARPS, int BK, bool BAND>
__device__ __forceinline__ void
flash_fwd_body(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
               float scale_log2, int window) {
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
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Sk);

  const __nv_bfloat16* qbh = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kbh = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vbh = v + b * sv.b + h * sv.h;

  load_tile(Qs, L.ld_in, qbh, sq.s, q0, BQ, Sq, D, L.dp, tid, NT);
  for (int i = tid; i < BQ * L.dp; i += NT) Os[(i / L.dp) * L.ld_o + i % L.dp] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    row_m[i] = -CUDART_INF_F;
    row_l[i] = 0.f;
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

  // normalise and write this warp's rows: out (B, Sq, H, D), lse (B, H, Sq)
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= Sq) break;
    const float l = row_l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(Os[r * L.ld_o + c] * inv);
    if (lane == 0) {
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          l > 0.f ? (row_m[r] + log2f(l)) * kLn2 : -CUDART_INF_F;
    }
  }
}

template <int NWARPS, int BK>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                 float scale_log2, int /*window*/) {
  flash_fwd_body<NWARPS, BK, false>(q, k, v, sq, sk, sv, out, lse, kv_lens, H, Sq, Sk, D,
                                    scale_log2, 0);
}

template <int NWARPS, int BK>
__global__ void __launch_bounds__(32 * NWARPS)
flash_window_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    const int* __restrict__ /*kv_lens*/, int H, int Sq, int Sk, int D,
                    float scale_log2, int window) {
  flash_fwd_body<NWARPS, BK, true>(q, k, v, sq, sk, sv, out, lse, nullptr, H, Sq, Sk, D,
                                   scale_log2, window);
}

template <int NWARPS, int BK, bool BAND>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           Strides sq, Strides sk, Strides sv, __nv_bfloat16* out, float* lse,
           const int* kv_lens, int B, int Sq, int Sk, int H, int D, float scale_log2,
           int window, cudaStream_t stream) {
  constexpr int BQ = 16 * NWARPS;
  const Layout L = make_layout(D, BQ, BK);
  auto kern = BAND ? flash_window_kernel<NWARPS, BK> : flash_fwd_kernel<NWARPS, BK>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, 32 * NWARPS, L.bytes, stream>>>(q, k, v, sq, sk, sv, out, lse, kv_lens, H, Sq,
                                               Sk, D, scale_log2, window);
  return static_cast<int>(cudaGetLastError());
}

template <bool BAND>
int dispatch(const void* q, const void* k, const void* v, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, void* out, void* lse, const void* kv_lens, int B,
             int Sq, int Sk, int H, int D, float scale, int window, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  // 64x64 tiles with 4 warps while they fit in ~200 KB of shared memory,
  // else 32x32 tiles with 2 warps (d=512 takes ~173 KB)
  if (make_layout(D, 64, 64).bytes <= 200 * 1024) {
    return launch<4, 64, BAND>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, sl2,
                               window, st);
  }
  if (make_layout(D, 32, 32).bytes <= 227 * 1024) {
    return launch<2, 32, BAND>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, sl2,
                               window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int cf_flash_attn_bf16(const void* q, const void* k, const void* v,
                                  long long qsb, long long qss, long long qsh,
                                  long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh,
                                  void* out, void* lse, const void* kv_lens,
                                  int B, int Sq, int Sk, int H, int D, float scale,
                                  void* stream) {
  return dispatch<false>(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, out, lse,
                         kv_lens, B, Sq, Sk, H, D, scale, 0, stream);
}

// Banded self-attention |i - j| <= window over S keys (Sq == Sk == S); a
// window >= S - 1 is full attention.
extern "C" int cf_flash_attn_window_bf16(const void* q, const void* k, const void* v,
                                         long long qsb, long long qss, long long qsh,
                                         long long ksb, long long kss, long long ksh,
                                         long long vsb, long long vss, long long vsh,
                                         void* out, void* lse, int B, int S, int H, int D,
                                         int window, float scale, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, out, lse,
                        nullptr, B, S, S, H, D, scale, window < S ? window : S, stream);
}

extern "C" const char* cf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
