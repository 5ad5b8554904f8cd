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

// Four consecutive elements as fp32: one 16-byte load of fp32, one 8-byte
// load of bf16 (the address aligned to that size)
__device__ inline void load4(const float* __restrict__ p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ inline void load4(const __nv_bfloat16* __restrict__ p, float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

// Four consecutive elements stored from fp32 (bf16 rounded to nearest, as
// from_f does), in one access
__device__ inline void store4(float* __restrict__ p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ inline void store4(__nv_bfloat16* __restrict__ p, const float (&o)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

constexpr int kThreads = 256;

// one thread per packed byte: N * C / per_byte threads
inline unsigned int n_blocks(int N, int C, int per_byte) {
  const long long total = static_cast<long long>(N) * (C / per_byte);
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace cfq
