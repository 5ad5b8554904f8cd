// Shared pieces of the error-feedback quant/dequant kernels
// (binary_quant.cu, int2_quant.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cfq {

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f(float x);
template <>
__device__ inline float from_f<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// scale[n, c] = sum_k u[n, k] * v[k, c] in fp32, k ascending.  Quant and
// dequant both call this, so they see the same scale bit for bit.
__device__ inline float scale_at(const __nv_bfloat16* __restrict__ u,
                                 const __nv_bfloat16* __restrict__ v, int n, int c, int C,
                                 int K) {
  float s = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    s += __bfloat162float(u[static_cast<long long>(n) * K + kk]) *
         __bfloat162float(v[static_cast<long long>(kk) * C + c]);
  }
  return s;
}

constexpr int kThreads = 256;

// one thread per packed byte: N * C / per_byte threads
inline unsigned int n_blocks(int N, int C, int per_byte) {
  const long long total = static_cast<long long>(N) * (C / per_byte);
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace cfq
