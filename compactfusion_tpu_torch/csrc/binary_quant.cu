// 1-bit error-feedback quantization: fused delta -> sign -> pack -> base
// update, and its inverse (unpack -> base + sign * scale).
//
// Replaces: compactfusion_tpu/ops/quant_pallas.py::binary_quant_fastpath
// (_binary_quant_kernel, pallas_call at quant_pallas.py:118) and
// ::binary_dequant_fastpath (_binary_dequant_kernel, quant_pallas.py:159).
//
// What bounds it on an H100: memory.  Quant reads x and base and writes the
// new base (about 12 bytes per fp32 element, plus 1/8 byte of packed signs)
// for a handful of flops, so it sits far below the ~295 FLOP/byte ridge; at
// the ring-8 PixArt shape (N=256, C=1152) the whole call moves ~3.5 MB and
// is as short as a launch.  Dequant moves ~8 bytes per element.
//
// Design: one thread per packed output byte (n, j).  It handles the 8
// channels i*(C/8)+j of the grouped wire layout (bit i of byte j, see
// compact/packing.py), so neighbouring threads read neighbouring addresses
// for every i and the byte is assembled in a register, with no shuffle.
// scale[n, c] = sum_k u[n, k] * v[k, c] is formed in fp32 in the same k order
// by both kernels, so quant's new base equals dequant's output bit for bit
// (the error-feedback consistency invariant the ring emulation relies on).
// delta >= 0 maps to +1, -0.0 included.  Needs C % 8 == 0; any N.

#include "quant_common.cuh"

namespace {

using cfq::from_f;
using cfq::scale_at;
using cfq::to_f;

template <typename TX, typename TB>
__global__ void binary_quant_kernel(const TX* __restrict__ x, const TB* __restrict__ base,
                                    const __nv_bfloat16* __restrict__ u,
                                    const __nv_bfloat16* __restrict__ v,
                                    uint8_t* __restrict__ packed, TB* __restrict__ new_base,
                                    int N, int C, int K) {
  const int G = C / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * G) return;
  const int n = static_cast<int>(idx / G);
  const int j = static_cast<int>(idx % G);
  const long long row = static_cast<long long>(n) * C;
  unsigned int byte = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = i * G + j;
    const float b = to_f(base[row + c]);
    const float delta = to_f(x[row + c]) - b;
    const float s = scale_at(u, v, n, c, C, K);
    const bool pos = delta >= 0.f;
    byte |= static_cast<unsigned int>(pos) << i;
    new_base[row + c] = from_f<TB>(b + (pos ? s : -s));
  }
  packed[idx] = static_cast<uint8_t>(byte);
}

template <typename TB>
__global__ void binary_dequant_kernel(const uint8_t* __restrict__ packed,
                                      const TB* __restrict__ base,
                                      const __nv_bfloat16* __restrict__ u,
                                      const __nv_bfloat16* __restrict__ v,
                                      TB* __restrict__ out, int N, int C, int K) {
  const int G = C / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * G) return;
  const int n = static_cast<int>(idx / G);
  const int j = static_cast<int>(idx % G);
  const long long row = static_cast<long long>(n) * C;
  const unsigned int byte = packed[idx];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = i * G + j;
    const float b = to_f(base[row + c]);
    const float s = scale_at(u, v, n, c, C, K);
    out[row + c] = from_f<TB>(b + (((byte >> i) & 1u) ? s : -s));
  }
}

template <typename TX, typename TB>
void quant(const void* x, const void* base, const void* u, const void* v, void* packed,
           void* new_base, int N, int C, int K, cudaStream_t st) {
  binary_quant_kernel<TX, TB><<<cfq::n_blocks(N, C, 8), cfq::kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TB*>(base),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
      static_cast<uint8_t*>(packed), static_cast<TB*>(new_base), N, C, K);
}

template <typename TB>
void dequant(const void* packed, const void* base, const void* u, const void* v, void* out,
             int N, int C, int K, cudaStream_t st) {
  binary_dequant_kernel<TB><<<cfq::n_blocks(N, C, 8), cfq::kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<const TB*>(base),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
      static_cast<TB*>(out), N, C, K);
}

}  // namespace

extern "C" int cf_binary_quant(const void* x, const void* base, const void* u, const void* v,
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

extern "C" int cf_binary_dequant(const void* packed, const void* base, const void* u,
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
