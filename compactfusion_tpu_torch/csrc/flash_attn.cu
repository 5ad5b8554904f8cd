// Non-causal flash attention with a natural-log LSE, bf16 or fp32 in, fp32
// math (fp32 in: the products in 3xTF32, flash_reg.cuh's note; the
// *_f32_kernel instantiations):
// full attention (flash_fwd_reg_kernel for head dims up to 128, on the
// register body of flash_reg.cuh, which fp32 takes; bf16 takes the wgmma
// body, flash_fwd_wgmma_kernel in flash_wgmma.cu; the wide body of
// flash_wide.cuh above,
// the register body split over warps by head-dim slices and above d = 512
// over the CTAs of a cluster, launched from flash_wide.cu) and banded
// attention |i - j| <= w (flash_window_reg_kernel on the register body up
// to 128; flash_window_wide_kernel on the wide body above).  The host picks
// the body, padded head dim and warps per CTA (ops/flash.py::flash_plan)
// and passes them in; the entry points launch exactly that or return an
// error.
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
// The VAE mid-block shape (d=512, S=4096, one head) is the same (34.4 GFLOP),
// with a head dim too wide for one warp's register accumulator: the wide
// body's note (flash_wide.cuh) says how its warps share a row.
//
// The banded kernel (DiTFastAttn's window attention; Sq == Sk, no kv_lens),
// on the register or the wide body:
//  * off-band tiles are skipped, not masked: the q-tile at q0 visits only the
//    KV tiles from that of max(0, q0 - w) to that of min(S - 1, q0 + BQ - 1
//    + w), and masks |i - j| > w inside them, so the work scales with S * w
//    (at w=64, S=1024, a 128-row tile visits 4 of 16 64-key tiles); only the
//    tiles not wholly inside a warp's (a row group's) band are masked, and a
//    warp (a row group) with no key in a visited tile skips it;
//  * a visited tile may hold no key of some row (w=4, q0=64: row 127 has
//    none in tile 0), so the running max can still be -inf after a tile and
//    the exponent is taken against 0 there instead of -inf - -inf = NaN;
//  * what bounds it: at B2 H16 S1024 d72, w=64 it must read q/k/v and write
//    out/LSE, ~19.0 MB (~5.7 us at 3.35 TB/s), against ~1.18 GFLOP of band
//    products (127,936 band pairs per head; ~1.2 us at 989 TFLOP/s): memory,
//    where the full kernel is bound by math.

// The tile bodies live in flash_reg.cuh and flash_wide.cuh, shared with the
// ring kernels of ring_flash.cu; kernel 1's wide kernels are built in their
// own source, flash_wide.cu, which nvcc compiles beside this one.
//
// ops/_build.py compiles this source twice, in parallel: CF_FLASH_PART 1
// holds the full-attention entry (and the error string), 2 the banded one.
// Each part instantiates only the kernels its entry reaches; without the
// define both entries are built.

#include "flash_wide.cuh"  // the wide body, kernel 1's launch in flash_wide.cu

namespace {

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_reg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                     float scale_log2) {
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_reg_tile<__nv_bfloat16, DP, NWARPS, false>(q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D,
                                                   scale_log2, blockIdx.x * 16 * NWARPS,
                                                   blockIdx.y, b, Carry{});
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_window_reg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int S,
                        int D, float scale_log2, int window) {
  flash_reg_tile<__nv_bfloat16, DP, NWARPS, false, kAllParts, true>(
      q, k, v, sq, sk, sv, out, lse, S, H, S, D, scale_log2, blockIdx.x * 16 * NWARPS, blockIdx.y,
      blockIdx.z, Carry{}, window);
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_reg_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                         float* __restrict__ out, float* __restrict__ lse,
                         const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                         float scale_log2) {
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_reg_tile<float, DP, NWARPS, false>(q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D,
                                           scale_log2, blockIdx.x * 16 * NWARPS, blockIdx.y, b,
                                           Carry{});
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_window_reg_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                            float* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
                            float scale_log2, int window) {
  flash_reg_tile<float, DP, NWARPS, false, kAllParts, true>(
      q, k, v, sq, sk, sv, out, lse, S, H, S, D, scale_log2, blockIdx.x * 16 * NWARPS, blockIdx.y,
      blockIdx.z, Carry{}, window);
}

template <typename T, int DP, int NWARPS, bool BAND>
int launch_reg(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv, T* out,
               float* lse, const int* kv_lens, int B, int Sq, int Sk, int H, int D,
               float scale_log2, int window, cudaStream_t stream) {
  constexpr int BQ = 16 * NWARPS, BYTES = RegLayout<DP, NWARPS, static_cast<int>(sizeof(T))>::kBytes;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if constexpr (BAND) {
    auto kern = [] {
      if constexpr (sizeof(T) == 4) return flash_window_reg_f32_kernel<DP, NWARPS>;
      else return flash_window_reg_kernel<DP, NWARPS>;
    }();
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, 32 * NWARPS, BYTES, stream>>>(q, k, v, sq, sk, sv, out, lse, H, Sq, D, scale_log2,
                                               window);
  } else {
    auto kern = [] {
      if constexpr (sizeof(T) == 4) return flash_fwd_reg_f32_kernel<DP, NWARPS>;
      else return flash_fwd_reg_kernel<DP, NWARPS>;
    }();
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, 32 * NWARPS, BYTES, stream>>>(q, k, v, sq, sk, sv, out, lse, kv_lens, H, Sq, Sk,
                                               D, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// kernel 4 on the wide body: CTA part (the cluster rank) of the query tile
// blockIdx.x / parts holds the columns [part DP, (part + 1) DP)
template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_window_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
                         float scale_log2, int window) {
  using L = WideLayout<DP, NWARPS, 2, true>;
  flash_wide_tile<__nv_bfloat16, DP, NWARPS, true, false, true>(
      q, k, v, sq, sk, sv, out, lse, S, H, S, D, scale_log2, blockIdx.x / cluster_size() * 16 * L::kGroups,
      blockIdx.y, blockIdx.z, Carry{}, window);
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_window_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                             float* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
                             float scale_log2, int window) {
  using L = WideLayout<DP, NWARPS, 4, true>;
  flash_wide_tile<float, DP, NWARPS, true, false, true>(
      q, k, v, sq, sk, sv, out, lse, S, H, S, D, scale_log2, blockIdx.x / cluster_size() * 16 * L::kGroups,
      blockIdx.y, blockIdx.z, Carry{}, window);
}

template <typename T, int DP, int NWARPS>
int launch_window_wide(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv, T* out,
                       float* lse, int B, int S, int H, int D, float scale_log2, int window, int parts,
                       cudaStream_t stream) {
  using L = WideLayout<DP, NWARPS, static_cast<int>(sizeof(T)), true>;
  constexpr int BQ = 16 * L::kGroups;
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return flash_window_wide_f32_kernel<DP, NWARPS>;
    else return flash_window_wide_kernel<DP, NWARPS>;
  }();
  return launch_split(kern, parts, dim3((S + BQ - 1) / BQ, H, B), 32 * NWARPS, L::kBytes, stream, q, k, v, sq, sk,
                      sv, out, lse, H, S, D, scale_log2, window);
}

// Launch the plan (body, dp, warps) on T elements: the register body at a
// built (dp, warps) with D <= dp, or the wide body: full attention through
// cf_flash_wide_launch, banded on clusters of wide_parts(dp) CTAs, each at
// (dp / parts, warps), one of CF_WIDE_PLANS; anything else is an error.
// BAND takes the banded kernel of the same body.
template <typename T, bool BAND>
int dispatch(const void* q, const void* k, const void* v, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, void* out, void* lse, const void* kv_lens, int B,
             int Sq, int Sk, int H, int D, float scale, int window, int body, int dp, int warps,
             void* stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  const cudaError_t refused = cudaErrorInvalidValue;
  if (D % 8 != 0 || D > dp) return static_cast<int>(refused);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  if (body == kRegBody) {
#define CF_REG_CASE(DPV, W)                                                                  \
  if (dp == DPV && warps == W) {                                                              \
    return launch_reg<T, DPV, W, BAND>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, sl2, \
                                       window, st);                                              \
  }
    CF_REG_PLANS(CF_REG_CASE)
#undef CF_REG_CASE
    return static_cast<int>(refused);
  }
  if (body != kWideBody) return static_cast<int>(refused);
  if constexpr (!BAND) {
    return cf_flash_wide_launch(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, out, lse, kv_lens, B, Sq,
                                Sk, H, D, sl2, dp, warps, kF32, stream);
  } else {
    const int parts = wide_parts(dp);
    if (parts == 0 || D <= (parts - 1) * (dp / parts)) return static_cast<int>(refused);
#define CF_WIDE_CASE(DPV, W)                                                                                \
  if (dp / parts == DPV && warps == W) {                                                                     \
    return launch_window_wide<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, H, D, sl2, window, parts, st); \
  }
    CF_WIDE_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
    return static_cast<int>(refused);
  }
}

}  // namespace

#if !defined(CF_FLASH_PART) || CF_FLASH_PART == 1
// Kernel 1 on bf16 q/k/v and out, or on fp32 ones with f32
extern "C" int cf_flash_attn(const void* q, const void* k, const void* v,
                             long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             void* out, void* lse, const void* kv_lens,
                             int B, int Sq, int Sk, int H, int D, float scale,
                             int body, int dp, int warps, int f32, void* stream) {
  auto run = f32 ? dispatch<float, false> : dispatch<__nv_bfloat16, false>;
  return run(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, out, lse, kv_lens, B, Sq, Sk, H,
             D, scale, 0, body, dp, warps, stream);
}

extern "C" const char* cf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif

#if !defined(CF_FLASH_PART) || CF_FLASH_PART == 2
// Banded self-attention |i - j| <= window over S keys (Sq == Sk == S); a
// window >= S - 1 is full attention.  bf16, or fp32 with f32.
extern "C" int cf_flash_attn_window(const void* q, const void* k, const void* v,
                                    long long qsb, long long qss, long long qsh,
                                    long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh,
                                    void* out, void* lse, int B, int S, int H, int D,
                                    int window, float scale, int body, int dp, int warps,
                                    int f32, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto run = f32 ? dispatch<float, true> : dispatch<__nv_bfloat16, true>;
  return run(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, out, lse, nullptr, B, S, S, H, D,
             scale, window < S ? window : S, body, dp, warps, stream);
}
#endif
