// Kernel 1's wide-head kernels on the body of flash_wide.cuh, which says
// what they replace and how they are laid out: flash_fwd_wide_kernel (bf16)
// and flash_fwd_wide_f32_kernel (fp32) at 128 < d <= 512, one CTA per query
// tile; flash_fwd_wide_split_kernel and flash_fwd_wide_split_f32_kernel above,
// the head dim split over a cluster of CTAs.  Their own source, so that nvcc
// builds their instantiations beside flash_attn.cu's; flash_attn.cu's entry
// cf_flash_attn hands it the plans of the wide body.

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

// kernel 1 above d = 512: CTA part (the cluster rank) of the query tile
// blockIdx.x / parts holds the columns [part DP, (part + 1) DP)
template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_wide_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                            float scale_log2) {
  using L = WideLayout<DP, NWARPS, 2, true>;
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_wide_tile<__nv_bfloat16, DP, NWARPS, false, false, true>(
      q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D, scale_log2,
      blockIdx.x / cluster_size() * 16 * L::kGroups, blockIdx.y, b);
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
flash_fwd_wide_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                                float* __restrict__ out, float* __restrict__ lse,
                                const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D,
                                float scale_log2) {
  using L = WideLayout<DP, NWARPS, 4, true>;
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  flash_wide_tile<float, DP, NWARPS, false, false, true>(
      q, k, v, sq, sk, sv, out, lse, kv_len, H, Sq, D, scale_log2,
      blockIdx.x / cluster_size() * 16 * L::kGroups, blockIdx.y, b);
}

template <typename T, int DP, int NWARPS>
int launch_wide_split(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv, T* out,
                      float* lse, const int* kv_lens, int B, int Sq, int Sk, int H, int D,
                      float scale_log2, int parts, cudaStream_t stream) {
  using L = WideLayout<DP, NWARPS, static_cast<int>(sizeof(T)), true>;
  constexpr int BQ = 16 * L::kGroups;
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return flash_fwd_wide_split_f32_kernel<DP, NWARPS>;
    else return flash_fwd_wide_split_kernel<DP, NWARPS>;
  }();
  return launch_split(kern, parts, dim3((Sq + BQ - 1) / BQ, H, B), 32 * NWARPS, L::kBytes, stream, q, k, v, sq,
                      sk, sv, out, lse, kv_lens, H, Sq, Sk, D, scale_log2);
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
  if (dp <= kWidePart) {
#define CF_WIDE_CASE(DPV, W)                                                                          \
  if (dp == DPV && warps == W) {                                                                       \
    return launch_wide<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, scale_log2, st); \
  }
    CF_WIDE_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above d = 512: every CTA of the cluster holds dp / parts columns, and
  // the last of them at least one column below D
  const int parts = wide_parts(dp);
  if (parts < 2 || D <= (parts - 1) * (dp / parts)) return static_cast<int>(cudaErrorInvalidValue);
#define CF_WIDE_CASE(DPV, W)                                                                                 \
  if (dp / parts == DPV && warps == W) {                                                                      \
    return launch_wide_split<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, lens, B, Sq, Sk, H, D, scale_log2, parts, \
                                        st);                                                                  \
  }
  CF_WIDE_SPLIT_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch flash_fwd_wide_kernel (f32: flash_fwd_wide_f32_kernel) at the plan
// (dp, warps), one of CF_WIDE_PLANS, with D <= dp; above dp = 512 the split
// kernels on clusters of wide_parts(dp) CTAs, each at (dp / parts, warps),
// one of CF_WIDE_SPLIT_PLANS; anything else is an error.
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
