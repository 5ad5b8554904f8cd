// 2-bit error-feedback quantization: fused delta -> sign + magnitude code ->
// pack -> base update, and its inverse (unpack -> base + level * scale).
//
// Replaces: compactfusion_tpu/ops/quant_pallas.py::int2_quant_fastpath
// (_int2_quant_kernel, pallas_call at quant_pallas.py:238) and
// ::int2_dequant_fastpath (_int2_dequant_kernel, quant_pallas.py:273).
//
// Codes, as the Pallas kernel forms them: s = sum_k u[n,k] * v[k,c] (fp32,
// from the bf16 wire scales); code = 2 * (delta >= 0) + (delta > s or
// delta < -s); levels -2s, -0.5s, +0.5s, +2s for codes 0..3.  The new base
// is base + level * s.  For K = 1 the scale is an exact product of two bf16
// values and level * s is exact (a power-of-two factor), so only the final
// add rounds, as in the plain twin.
//
// What bounds it on an H100: memory.  Quant reads x and base and writes the
// new base (~12 bytes per fp32 element plus 1/4 byte of codes); at the
// ring-8 PixArt shape (N=256, C=1152, fp32) it moves ~3.5 MB per call and
// dequant ~2.4 MB, for a few flops per element.
//
// Design: one thread per packed output byte (n, j).  It handles the 4
// channels i*(C/4)+j of the grouped wire layout (crumb i of byte j, see
// compact/packing.py), so neighbouring threads read neighbouring addresses
// for every i, and builds the byte in a register.  Quant and dequant form
// the scale with the same function (quant_common.cuh), so dequant rebuilds
// quant's new base bit for bit: the error-feedback consistency invariant.
// Needs C % 4 == 0; any N (the ragged edge is masked).

#include "quant_common.cuh"

namespace {

using cfq::from_f;
using cfq::scale_at;
using cfq::to_f;

__device__ inline float int2_step(bool pos, bool mag) {
  return (pos ? 1.f : -1.f) * (mag ? 2.f : 0.5f);
}

template <typename TX, typename TB>
__global__ void int2_quant_kernel(const TX* __restrict__ x, const TB* __restrict__ base,
                                  const __nv_bfloat16* __restrict__ u,
                                  const __nv_bfloat16* __restrict__ v,
                                  uint8_t* __restrict__ packed, TB* __restrict__ new_base, int N,
                                  int C, int K) {
  const int G = C / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * G) return;
  const int n = static_cast<int>(idx / G);
  const int j = static_cast<int>(idx % G);
  const long long row = static_cast<long long>(n) * C;
  unsigned int byte = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i * G + j;
    const float b = to_f(base[row + c]);
    const float delta = to_f(x[row + c]) - b;
    const float s = scale_at(u, v, n, c, C, K);
    const bool pos = delta >= 0.f;
    const bool mag = (delta > s) || (delta < -s);
    byte |= (2u * static_cast<unsigned int>(pos) + static_cast<unsigned int>(mag)) << (2 * i);
    new_base[row + c] = from_f<TB>(b + int2_step(pos, mag) * s);
  }
  packed[idx] = static_cast<uint8_t>(byte);
}

template <typename TB>
__global__ void int2_dequant_kernel(const uint8_t* __restrict__ packed,
                                    const TB* __restrict__ base,
                                    const __nv_bfloat16* __restrict__ u,
                                    const __nv_bfloat16* __restrict__ v, TB* __restrict__ out,
                                    int N, int C, int K) {
  const int G = C / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * G) return;
  const int n = static_cast<int>(idx / G);
  const int j = static_cast<int>(idx % G);
  const long long row = static_cast<long long>(n) * C;
  const unsigned int byte = packed[idx];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i * G + j;
    const unsigned int code = (byte >> (2 * i)) & 3u;
    const float b = to_f(base[row + c]);
    const float s = scale_at(u, v, n, c, C, K);
    out[row + c] = from_f<TB>(b + int2_step(code >= 2u, (code & 1u) != 0u) * s);
  }
}

template <typename TX, typename TB>
void quant(const void* x, const void* base, const void* u, const void* v, void* packed,
           void* new_base, int N, int C, int K, cudaStream_t st) {
  int2_quant_kernel<TX, TB><<<cfq::n_blocks(N, C, 4), cfq::kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TB*>(base),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
      static_cast<uint8_t*>(packed), static_cast<TB*>(new_base), N, C, K);
}

template <typename TB>
void dequant(const void* packed, const void* base, const void* u, const void* v, void* out,
             int N, int C, int K, cudaStream_t st) {
  int2_dequant_kernel<TB><<<cfq::n_blocks(N, C, 4), cfq::kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<const TB*>(base),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
      static_cast<TB*>(out), N, C, K);
}

}  // namespace

extern "C" int cf_int2_quant(const void* x, const void* base, const void* u, const void* v,
                             void* packed, void* new_base, int N, int C, int K, int x_bf16,
                             int base_bf16, void* stream) {
  if (N == 0 || C == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && base_bf16) {
    quant<__nv_bfloat16, __nv_bfloat16>(x, base, u, v, packed, new_base, N, C, K, st);
  } else if (x_bf16) {
    quant<__nv_bfloat16, float>(x, base, u, v, packed, new_base, N, C, K, st);
  } else if (base_bf16) {
    quant<float, __nv_bfloat16>(x, base, u, v, packed, new_base, N, C, K, st);
  } else {
    quant<float, float>(x, base, u, v, packed, new_base, N, C, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cf_int2_dequant(const void* packed, const void* base, const void* u,
                               const void* v, void* out, int N, int C, int K, int base_bf16,
                               void* stream) {
  if (N == 0 || C == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (base_bf16) {
    dequant<__nv_bfloat16>(packed, base, u, v, out, N, C, K, st);
  } else {
    dequant<float>(packed, base, u, v, out, N, C, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}
