// Kernel 1's wide-head kernel, flash_fwd_wide_kernel (128 < d <= 512), on
// the body of flash_wide.cuh, which says what it replaces and how it is
// laid out.  Its own source, so that nvcc builds its instantiations beside
// flash_attn.cu's; flash_attn.cu's entry cf_flash_attn_bf16 hands it the
// plans of the wide body.

#include "flash_wide.cuh"

namespace {

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                      float scale_log2) {
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_wide_tile<__nv_bfloat16, DP, NWARPS>(q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D,
                                             scale_log2,
                                             blockIdx.x * 16 * WideLayout<DP, NWARPS>::kGroups,
                                             blockIdx.y, b);
}

template <int DP, int NWARPS>
int launch_wide(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                Strides sq, Strides sk, Strides sv, __nv_bfloat16* out, float* lse,
                const int* kv_lens, int B, int Sq, int Sk, int H, int D, float scale_log2,
                cudaStream_t stream) {
  using L = WideLayout<DP, NWARPS>;
  constexpr int BQ = 16 * L::kGroups;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  auto kern = flash_fwd_wide_kernel<DP, NWARPS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, 32 * NWARPS, L::kBytes, stream>>>(q, k, v, sq, sk, sv, out, lse, kv_lens, H, Sq, Sk, D,
                                                 scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch flash_fwd_wide_kernel at the plan (dp, warps), one of
// CF_WIDE_PLANS, with D <= dp; anything else is an error.
extern "C" int cf_flash_wide_launch(const void* q, const void* k, const void* v, long long qsb,
                                    long long qss, long long qsh, long long ksb, long long kss,
                                    long long ksh, long long vsb, long long vss, long long vsh,
                                    void* out, void* lse, const void* kv_lens, int B, int Sq,
                                    int Sk, int H, int D, float scale_log2, int dp, int warps,
                                    void* stream) {
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > dp) return static_cast<int>(cudaErrorInvalidValue);
#define CF_WIDE_CASE(DPV, W)                                                                       \
  if (dp == DPV && warps == W) {                                                                    \
    return launch_wide<DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, scale_log2, st); \
  }
  CF_WIDE_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
