// Profiling probes of the flash kernel (kernel 1, csrc/flash_attn.cu):
//
//  * flash_parts_kernel<PARTS>: kernel 1's register body (flash_reg.cuh),
//    grid, block and shared-memory ring at the self-attention shape's plan
//    (DP 80, kProbeWarps warps) with stages switched off, one instantiation
//    per stage mask.  Replaces the doctored copies of the single-block
//    Pallas flash kernel in _prof_kernel_parts.py::build (pallas_call at
//    _prof_kernel_parts.py:69, kernel at :28-65).  The full mask is the
//    production body itself.
//  * dma_only_kernel: the same grid and shared memory, the Q tile and every
//    K/V tile through the body's cp.async ring, no S^2 work; it writes
//    q + k + v of the CTA's own rows (the `dma_only` variant of the same
//    script).
//  * plumb_kernel: reads q, k and v once through their (b, s, h) strides and
//    writes (q + k) + v contiguous: what attention must move, none of its
//    math.  Replaces _prof2_dbg.py::_plumb (pallas_call at _prof2_dbg.py:75).
//  * empty_kernel: one CTA of one thread that does nothing: timed by CUDA
//    graphs, the least a launch costs on the card (the floor under the
//    quant kernels' times).  No TPU kernel stands behind it.
//
// What bounds them on an H100: flash_parts as kernel 1 (operations; each
// switched-off stage shows what it costs), dma_only and plumb by bytes (at
// B2 H16 S1024 d72, 4 x 4.7 MB in and out: ~5.6 us at 3.35 TB/s).  plumb
// reads 16 bytes a thread, neighbouring threads on neighbouring addresses
// of one row; a row's 72 values are 9 such reads.
//
// bf16 sums round after each add, (q + k) + v, as the Pallas kernels do.

#include "flash_reg.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // plumb's rows per CTA
// kernel 1's plan at B2 H16 S1024 d72 (ops/flash.py::flash_plan), which the
// stage probe runs
constexpr int kProbeDP = 80;
constexpr int kProbeWarps = 8;

__global__ void empty_kernel() {}

__device__ inline __nv_bfloat16 add3(__nv_bfloat16 a, __nv_bfloat16 b, __nv_bfloat16 c) {
  const __nv_bfloat16 ab = __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
  return __float2bfloat16(__bfloat162float(ab) + __bfloat162float(c));
}

template <int PARTS>
__global__ void __launch_bounds__(32 * kProbeWarps)
flash_parts_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
                   float scale_log2) {
  flash_reg_tile<__nv_bfloat16, kProbeDP, kProbeWarps, false, PARTS>(
      q, k, v, sq, sk, sv, out, lse, S, H, S, D, scale_log2, blockIdx.x * 16 * kProbeWarps,
      blockIdx.y, blockIdx.z, Carry{});
}

__global__ void __launch_bounds__(32 * kProbeWarps)
dma_only_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                __nv_bfloat16* __restrict__ out, int H, int S, int D) {
  using T = __nv_bfloat16;
  using L = RegLayout<kProbeDP, kProbeWarps>;
  constexpr int BK = kRegBK, BQ = 16 * kProbeWarps, NT = 32 * kProbeWarps, LD = L::kLd;
  constexpr int STAGES = L::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::kQBytes);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* kbh = k + b * sk.b + h * sk.h;
  const T* vbh = v + b * sv.b + h * sv.h;
  const int n_tiles = (S + BK - 1) / BK;
  auto load_kv = [&](int t) {
    T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    async_tile<T, BK, kProbeDP, LD, NT>(Ks, kbh, sk.s, t * BK, S, D, tid);
    async_tile<T, BK, kProbeDP, LD, NT>(Ks + BK * LD, vbh, sv.s, t * BK, S, D, tid);
  };
  // the loads of flash_reg_tile: Q and the K/V tiles through the same ring
  async_tile<T, BQ, kProbeDP, LD, NT>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, D, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    cp_async_commit();
    const T* Ks = ring + (t % STAGES) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;
    // the CTA's own rows that this K/V tile holds
    const int lo = max(k0, q0), hi = min(min(k0 + BK, q0 + BQ), S);
    for (int i = tid; i < (hi - lo) * D; i += NT) {
      const int row = lo + i / D, c = i % D;
      out[((static_cast<long long>(b) * S + row) * H + h) * D + c] =
          add3(Qs[(row - q0) * LD + c], Ks[(row - k0) * LD + c], Vs[(row - k0) * LD + c]);
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(32 * kWarps)
plumb_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
             __nv_bfloat16* __restrict__ out, int H, int S, int D) {
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kTile * chunks; i += blockDim.x) {
    const int row = q0 + i / chunks, c = (i % chunks) * 8;
    if (row >= S) break;
    const uint4 a = *reinterpret_cast<const uint4*>(q + b * sq.b + row * sq.s + h * sq.h + c);
    const uint4 bb = *reinterpret_cast<const uint4*>(k + b * sk.b + row * sk.s + h * sk.h + c);
    const uint4 cc = *reinterpret_cast<const uint4*>(v + b * sv.b + row * sv.s + h * sv.h + c);
    const auto* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
    const auto* pb = reinterpret_cast<const __nv_bfloat16*>(&bb);
    const auto* pc = reinterpret_cast<const __nv_bfloat16*>(&cc);
    uint4 res;
    auto* pr = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) pr[e] = add3(pa[e], pb[e], pc[e]);
    *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * S + row) * H + h) * D + c) = res;
  }
}

template <int PARTS>
int launch_parts(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 Strides sq, Strides sk, Strides sv, __nv_bfloat16* out, float* lse, int B,
                 int S, int H, int D, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * kProbeWarps, BYTES = RegLayout<kProbeDP, kProbeWarps>::kBytes;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaError_t e;
  if constexpr (PARTS == 0) {
    e = cudaFuncSetAttribute(dma_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    dma_only_kernel<<<grid, 32 * kProbeWarps, BYTES, stream>>>(q, k, v, sq, sk, sv, out, H, S, D);
  } else {
    e = cudaFuncSetAttribute(flash_parts_kernel<PARTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the factor of a score: kernel 1's scale * log2e with the exponent,
    // the plain scale without it
    const float factor = (PARTS & kExp) != 0 ? scale * kLog2e : scale;
    flash_parts_kernel<PARTS><<<grid, 32 * kProbeWarps, BYTES, stream>>>(q, k, v, sq, sk, sv, out,
                                                                         lse, H, S, D, factor);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Self-attention over S keys (Sq == Sk == S, S % 64 == 0, D % 8 == 0) with
// the stages of `parts` (a Part mask; 0 is dma_only) on the register body
// at the plan (dp, warps), which must be the probe's (80, kProbeWarps);
// out (B, S, H, D) contiguous, lse (B, H, S) written only with every stage
// on.  Only the masks of the probe's variants are built.
extern "C" int cf_flash_parts_bf16(const void* q, const void* k, const void* v,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   void* out, void* lse, int B, int S, int H, int D, float scale,
                                   int parts, int dp, int warps, void* stream) {
  if (S % kRegBK || D % 8 || D > dp || dp != kProbeDP || warps != kProbeWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
#define CF_PARTS_CASE(MASK) \
  case (MASK):              \
    return launch_parts<(MASK)>(qp, kp, vp, sq, sk, sv, op, lp, B, S, H, D, scale, st);
  switch (parts) {
    CF_PARTS_CASE(kAllParts)                                  // full
    CF_PARTS_CASE(0)                                          // dma_only
    CF_PARTS_CASE(kAllParts & ~kScale)                        // no_scale
    CF_PARTS_CASE(kAllParts & ~kMax)                          // no_max
    CF_PARTS_CASE(kAllParts & ~kExp)                          // no_exp
    CF_PARTS_CASE(kAllParts & ~kQK)                           // no_qk
    CF_PARTS_CASE(kAllParts & ~kAV)                           // no_av
    CF_PARTS_CASE(kQK | kAV)                                  // matmuls_only
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CF_PARTS_CASE
}

// (q + k) + v of (B, S, H, D) views with a unit head-dim stride, written
// contiguous (B, S, H, D); D % 8 == 0, 16-byte aligned rows.
extern "C" int cf_plumb_bf16(const void* q, const void* k, const void* v,
                             long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             void* out, int B, int S, int H, int D, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  plumb_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
      Strides{vsb, vss, vsh}, static_cast<__nv_bfloat16*>(out), H, S, D);
  return static_cast<int>(cudaGetLastError());
}

// One launch of empty_kernel on the stream
extern "C" int cf_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
