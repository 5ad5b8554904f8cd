// Kernels 1 and 7 (and so kernel 8's flash partial) on bf16 q/k/v at head
// dims up to 128, on the wgmma body of flash_wgmma.cuh (its note says what
// they replace, what bounds them and how the body is built), and the
// encoder of the TMA tensor maps they read q, k and v through.
//
// The host computes each map's dims, byte strides and box
// (ops/flash.py::tma_view) and encodes it once per tensor view with
// cf_tma_map (the ring: q once per call, k and v once per hop); the entry
// points take the encoded maps and the plan (padded head dim, consumer
// warps) of ops/flash.py::flash_plan and launch exactly that, or return an
// error.  cuTensorMapEncodeTiled is a driver function: it is reached
// through cudaGetDriverEntryPoint, so the library links no libcuda.
//
// ops/_build.py compiles this source twice, in parallel: CF_WG_PART 1 holds
// the encoder and kernel 1, 2 kernel 7; without the define both are built.

#include <string.h>

#include "flash_wgmma.cuh"

namespace {

// The tensor maps of q, k and v: each one of 64-column boxes and one of the
// tail's (at DP 64 and 128 a copy of the first, unused)
struct WgMaps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail;
};

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS + 128, NWARPS == 4 ? 2 : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ WgMaps maps, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ kv_lens, int H, int Sq, int Sk, int D, float scale_log2) {
  const int b = blockIdx.z;
  const int kv_len = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  const CUtensorMap* const tq[2] = {&maps.q, &maps.q_tail};
  const CUtensorMap* const tk[2] = {&maps.k, &maps.k_tail};
  const CUtensorMap* const tv[2] = {&maps.v, &maps.v_tail};
  flash_wgmma_tile<DP, NWARPS, false>(tq, tk, tv, out, lse, kv_len, H, Sq, D, scale_log2, blockIdx.x * 16 * NWARPS,
                                      blockIdx.y, b, Carry{});
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS + 128, NWARPS == 4 ? 2 : 1)
ring_flash_hop_wgmma_kernel(const __grid_constant__ WgMaps maps, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale_log2, Carry carry) {
  const CUtensorMap* const tq[2] = {&maps.q, &maps.q_tail};
  const CUtensorMap* const tk[2] = {&maps.k, &maps.k_tail};
  const CUtensorMap* const tv[2] = {&maps.v, &maps.v_tail};
  flash_wgmma_tile<DP, NWARPS, true>(tq, tk, tv, out, lse, Sk, H, Sq, D, scale_log2, blockIdx.x * 16 * NWARPS,
                                     blockIdx.y, blockIdx.z, carry);
}

// One launch at (DP, NWARPS): kernel 1, or with `carry` kernel 7's hop
template <int DP, int NWARPS, bool CARRY>
int launch_wgmma(const WgMaps& maps, __nv_bfloat16* out, float* lse, const int* kv_lens, Carry carry, int B, int Sq,
                 int Sk, int H, int D, float scale_log2, cudaStream_t stream) {
  constexpr int BYTES = WgLayout<DP, NWARPS>::kBytes, THREADS = 32 * NWARPS + 128;
  const dim3 grid((Sq + 16 * NWARPS - 1) / (16 * NWARPS), H, B);
  if constexpr (CARRY) {
    auto kern = ring_flash_hop_wgmma_kernel<DP, NWARPS>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, THREADS, BYTES, stream>>>(maps, out, lse, H, Sq, Sk, D, scale_log2, carry);
  } else {
    auto kern = flash_fwd_wgmma_kernel<DP, NWARPS>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, THREADS, BYTES, stream>>>(maps, out, lse, kv_lens, H, Sq, Sk, D, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan (dp, warps) of CF_WG_PLANS with D <= dp on the maps (`map` the
// 64-column boxes of q, k, v, `tail` those of the tail or null at DP 64 and
// 128), or an error
template <bool CARRY>
int dispatch_wgmma(const void* const (&map)[3], const void* const (&tail)[3], void* out, void* lse,
                   const void* kv_lens, Carry carry, int B, int Sq, int Sk, int H, int D, float scale, int dp,
                   int warps, void* stream) {
  if (D % 8 != 0 || D > dp || map[0] == nullptr || map[1] == nullptr || map[2] == nullptr ||
      (dp % 64 != 0) != (tail[0] != nullptr && tail[1] != nullptr && tail[2] != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Sq == 0 || H == 0) return 0;
  WgMaps maps;
  CUtensorMap* const mine[3] = {&maps.q, &maps.k, &maps.v};
  CUtensorMap* const mine_tail[3] = {&maps.q_tail, &maps.k_tail, &maps.v_tail};
  for (int i = 0; i < 3; ++i) {
    memcpy(mine[i], map[i], sizeof(CUtensorMap));
    memcpy(mine_tail[i], tail[i] != nullptr ? tail[i] : map[i], sizeof(CUtensorMap));
  }
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
#define CF_WG_CASE(DPV, W)                                                                                    \
  if (dp == DPV && warps == W) {                                                                               \
    return launch_wgmma<DPV, W, CARRY>(maps, op, lp, lens, carry, B, Sq, Sk, H, D, sl2, st);             \
  }
  CF_WG_PLANS(CF_WG_CASE)
#undef CF_WG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#if !defined(CF_WG_PART) || CF_WG_PART == 1
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The 4-D TMA tensor map (128 bytes, into `map`) of a bf16 (B, S, H, D) view
// at `base`: dims (D, S, H, B) in elements, the byte strides of S, H and B,
// boxes of box_cols x box_rows x 1 x 1 with a swizzle of `swizzle` bytes
// (32, 64 or 128: box_cols * 2), out-of-bounds elements read as 0.
extern "C" int cf_tma_map(void* map, const void* base, long long d, long long s, long long h, long long b,
                          long long stride_s, long long stride_h, long long stride_b, int box_cols, int box_rows,
                          int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (map == nullptr || box_cols * 2 != swizzle) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapSwizzle swz = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swz == CU_TENSOR_MAP_SWIZZLE_NONE) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_s), static_cast<cuuint64_t>(stride_h),
                                 static_cast<cuuint64_t>(stride_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap m;
  const CUresult r = encode(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map, &m, sizeof m);
  return 0;
}

// Kernel 1 on the wgmma body: the maps of q (box rows: the plan's 16 *
// warps), k and v (kWgBK), each of 64-column boxes and, at DP 80 and 96,
// of the tail's (else null), out (B, Sq, H, D) contiguous, lse (B, H, Sq),
// kv_lens (B,) or null
extern "C" int cf_flash_wgmma(const void* qmap, const void* qtail, const void* kmap, const void* ktail,
                              const void* vmap, const void* vtail, void* out, void* lse, const void* kv_lens, int B,
                              int Sq, int Sk, int H, int D, float scale, int dp, int warps, void* stream) {
  const void* const map[3] = {qmap, kmap, vmap};
  const void* const tail[3] = {qtail, ktail, vtail};
  return dispatch_wgmma<false>(map, tail, out, lse, kv_lens, Carry{}, B, Sq, Sk, H, D, scale, dp, warps, stream);
}
#endif

#if !defined(CF_WG_PART) || CF_WG_PART == 2
// One hop of kernel 7 on the wgmma body, folded into the state m, l (B, H,
// Sq), acc (B, H, Sq, D) fp32; the last hop writes out and lse
extern "C" int cf_ring_flash_hop_wgmma(const void* qmap, const void* qtail, const void* kmap, const void* ktail,
                                       const void* vmap, const void* vtail, void* m, void* l, void* acc, void* out,
                                       void* lse, int B, int Sq, int Sk, int H, int D, float scale, int first,
                                       int last, int dp, int warps, void* stream) {
  const Carry carry{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc), first, last};
  const void* const map[3] = {qmap, kmap, vmap};
  const void* const tail[3] = {qtail, ktail, vtail};
  return dispatch_wgmma<true>(map, tail, out, lse, nullptr, carry, B, Sq, Sk, H, D, scale, dp, warps, stream);
}
#endif
