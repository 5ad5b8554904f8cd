// Kernel 1's wide-head kernels, flash_fwd_wide_kernel (bf16) and
// flash_fwd_wide_f32_kernel (fp32) at 128 < d <= 512, on the body of
// flash_wide.cuh, which says what it replaces and how it is laid out.  Its
// own source, so that nvcc builds its instantiations beside flash_attn.cu's;
// flash_attn.cu's entry cf_flash_attn hands it the plans of the wide body.

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
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                          float* __restrict__ out, float* __restrict__ lse,
                          const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                          float scale_log2) {
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_wide_tile<float, DP, NWARPS>(q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D, scale_log2,
                                     blockIdx.x * 16 * WideLayout<DP, NWARPS, 4>::kGroups, blockIdx.y,
                                     b);
}

template <typename T, int DP, int NWARPS>
int launch_wide(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv, T* out,
                float* lse, const int* kv_lens, int B, int Sq, int Sk, int H, int D,
                float scale_log2, cudaStream_t stream) {
  using L = WideLayout<DP, NWARPS, static_cast<int>(sizeof(T))>;
  constexpr int BQ = 16 * L::kGroups;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return flash_fwd_wide_f32_kernel<DP, NWARPS>;
    else return flash_fwd_wide_kernel<DP, NWARPS>;
  }();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, 32 * NWARPS, L::kBytes, stream>>>(q, k, v, sq, sk, sv, out, lse, kv_lens, H, Sq, Sk, D,
                                                 scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wide(const void* q, const void* k, const void* v, Strides sq, Strides sk, Strides sv,
                  void* out, void* lse, const void* kv_lens, int B, int Sq, int Sk, int H, int D,
                  float scale_log2, int dp, int warps, cudaStream_t st) {
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* lens = static_cast<const int*>(kv_lens);
#define CF_WIDE_CASE(DPV, W)                                                                          \
  if (dp == DPV && warps == W) {                                                                       \
    return launch_wide<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, scale_log2, st); \
  }
  CF_WIDE_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch flash_fwd_wide_kernel (f32: flash_fwd_wide_f32_kernel) at the plan
// (dp, warps), one of CF_WIDE_PLANS, with D <= dp; anything else is an
// error.
extern "C" int cf_flash_wide_launch(const void* q, const void* k, const void* v, long long qsb,
                                    long long qss, long long qsh, long long ksb, long long kss,
                                    long long ksh, long long vsb, long long vss, long long vsh,
                                    void* out, void* lse, const void* kv_lens, int B, int Sq,
                                    int Sk, int H, int D, float scale_log2, int dp, int warps,
                                    int f32, void* stream) {
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > dp) return static_cast<int>(cudaErrorInvalidValue);
  if (f32) {
    return dispatch_wide<float>(q, k, v, sq, sk, sv, out, lse, kv_lens, B, Sq, Sk, H, D, scale_log2, dp,
                                warps, st);
  }
  return dispatch_wide<__nv_bfloat16>(q, k, v, sq, sk, sv, out, lse, kv_lens, B, Sq, Sk, H, D, scale_log2,
                                      dp, warps, st);
}
