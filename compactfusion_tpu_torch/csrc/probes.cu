// Profiling probes of the flash kernel (kernel 1, csrc/flash_attn.cu):
//
//  * flash_parts_kernel<PARTS>: kernel 1's grid, block and shared-memory
//    layout around the shared tile body (flash_common.cuh) with stages
//    switched off, one instantiation per stage mask.  Replaces the doctored
//    copies of the single-block Pallas flash kernel in
//    _prof_kernel_parts.py::build (pallas_call at _prof_kernel_parts.py:69,
//    kernel at :28-65).  The full mask is the production body itself.
//  * dma_only_kernel: the same grid and shared memory, the Q tile and every
//    K/V tile load of the real loop, no S^2 work; it writes q + k + v of the
//    CTA's own rows (the `dma_only` variant of the same script).
//  * plumb_kernel: reads q, k and v once through their (b, s, h) strides and
//    writes (q + k) + v contiguous: what attention must move, none of its
//    math.  Replaces _prof2_dbg.py::_plumb (pallas_call at _prof2_dbg.py:75).
//
// What bounds them on an H100: flash_parts as kernel 1 (operations; each
// switched-off stage shows what it costs), dma_only and plumb by bytes (at
// B2 H16 S1024 d72, 4 x 4.7 MB in and out: ~5.6 us at 3.35 TB/s).  plumb
// reads 16 bytes a thread, neighbouring threads on neighbouring addresses
// of one row; a row's 72 values are 9 such reads.
//
// bf16 sums round after each add, (q + k) + v, as the Pallas kernels do.

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // query rows and keys per tile: kernel 1's 64x64 tiles

__device__ inline __nv_bfloat16 add3(__nv_bfloat16 a, __nv_bfloat16 b, __nv_bfloat16 c) {
  const __nv_bfloat16 ab = __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
  return __float2bfloat16(__bfloat162float(ab) + __bfloat162float(c));
}

template <int PARTS>
__global__ void __launch_bounds__(32 * kWarps)
flash_parts_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
                   float scale_log2) {
  flash_tile<kWarps, kTile, false, false, PARTS>(q, k, v, sq, sk, sv, out, lse, S, H, S, S, D,
                                                 scale_log2, 0, blockIdx.x * kTile, blockIdx.y,
                                                 blockIdx.z, Carry{});
}

__global__ void __launch_bounds__(32 * kWarps)
dma_only_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                __nv_bfloat16* __restrict__ out, int H, int S, int D) {
  constexpr int NT = 32 * kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(D, kTile, kTile);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.off_k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_v);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kbh = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vbh = v + b * sv.b + h * sv.h;

  load_tile(Qs, L.ld_in, q + b * sq.b + h * sq.h, sq.s, q0, kTile, S, D, L.dp, tid, NT);
  const int own = q0 / kTile;  // the KV tile that holds this CTA's own rows
  for (int t = 0; t < (S + kTile - 1) / kTile; ++t) {
    __syncthreads();
    load_tile(Ks, L.ld_in, kbh, sk.s, t * kTile, kTile, S, D, L.dp, tid, NT);
    load_tile(Vs, L.ld_in, vbh, sv.s, t * kTile, kTile, S, D, L.dp, tid, NT);
    __syncthreads();
    if (t != own) continue;
    for (int i = tid; i < kTile * D; i += NT) {
      const int r = i / D, c = i % D, row = q0 + r;
      if (row >= S) break;
      const int at = r * L.ld_in + c;
      out[((static_cast<long long>(b) * S + row) * H + h) * D + c] = add3(Qs[at], Ks[at], Vs[at]);
    }
  }
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
  const Layout L = make_layout(D, kTile, kTile);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaError_t e;
  if constexpr (PARTS == 0) {
    e = cudaFuncSetAttribute(dma_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dma_only_kernel<<<grid, 32 * kWarps, L.bytes, stream>>>(q, k, v, sq, sk, sv, out, H, S, D);
  } else {
    e = cudaFuncSetAttribute(flash_parts_kernel<PARTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the factor of a score: kernel 1's scale * log2e with the exponent,
    // the plain scale without it
    const float factor = (PARTS & kExp) != 0 ? scale * kLog2e : scale;
    flash_parts_kernel<PARTS><<<grid, 32 * kWarps, L.bytes, stream>>>(q, k, v, sq, sk, sv, out,
                                                                      lse, H, S, D, factor);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Self-attention over S keys (Sq == Sk == S, S % 64 == 0, D % 8 == 0 and the
// 64x64 layout within 200 KB) with the stages of `parts` (a Part mask; 0 is
// dma_only); out (B, S, H, D) contiguous, lse (B, H, S) written only with
// every stage on.  Only the masks of the probe's variants are built.
extern "C" int cf_flash_parts_bf16(const void* q, const void* k, const void* v,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   void* out, void* lse, int B, int S, int H, int D, float scale,
                                   int parts, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (S % kTile || D % 8 || make_layout(D, kTile, kTile).bytes > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
