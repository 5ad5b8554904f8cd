// Shared pieces of the error-feedback quant/dequant kernels
// (binary_quant.cu, int2_quant.cu): the element conversions, the scale, the
// 4-wide accesses, and the constants, scales and plan rule of the vector
// kernels.
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

// The vector kernels (binary and INT2 quant and dequant): packed bytes per
// thread, which ops/quant.py::QUANT_VEC_BYTES repeats, and threads per
// CTA.  Thread (n, j) takes packed bytes j..j+kVecBytes-1 of row n, so each
// of its channel groups is kVecBytes consecutive channels: one 16-byte
// access of fp32 (8 of bf16).
constexpr int kVecBytes = 4;
constexpr int kVecThreads = 64;

// The loads of the vector dequants and of INT2 quant's vector kernel: plain
// (coherent) ld.global in inline PTX, with a memory clobber, which the
// compiler keeps in program order ahead of every later store.  Through C++ loads, with or without __restrict__,
// ptxas placed each group's loads next to their use, after the previous
// group's store: 8 of a binary thread's 18 loads ahead of its first store
// (32 registers), so each thread waited on several DRAM round trips.
//
// The kVecBytes packed bytes at p (4-byte aligned) as one word: byte e in
// bits [8e, 8e + 8)
__device__ inline uint32_t load_packed(const uint8_t* p) {
  uint32_t w;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(w) : "l"(p) : "memory");
  return w;
}
// one bf16 value as fp32
__device__ inline float load_bf16_in_order(const __nv_bfloat16* p) {
  unsigned short h;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(h) : "l"(p) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(h));
}
// load4's accesses, in order
__device__ inline void load4_in_order(const float* p, float (&o)[4]) {
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(o[0]), "=f"(o[1]), "=f"(o[2]), "=f"(o[3]) : "l"(p) : "memory");
}
__device__ inline void load4_in_order(const __nv_bfloat16* p, float (&o)[4]) {
  uint2 t;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];" : "=r"(t.x), "=r"(t.y) : "l"(p) : "memory");
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

// The scales of one vector quant or dequant thread: sc[i][e] = sum_k u[n,
// k] * v[k, i*G + j + e], each summed from 0.f with k ascending as scale_at
// sums it (so every plan of either side sees the same bits).  KT > 0 is K known
// at compile time: every u and v load is issued before the first product,
// one round trip; KT == 0 walks a runtime K.
template <int GROUPS, int KT>
__device__ inline void vec_scales(const __nv_bfloat16* u, const __nv_bfloat16* v, int n, int j,
                                  int G, int C, int K, float (&sc)[GROUPS][4]) {
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
  }
  if constexpr (KT > 0) {
    float uk[KT], vv[KT][GROUPS][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uk[kk] = load_bf16_in_order(u + static_cast<long long>(n) * KT + kk);
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) {
        load4_in_order(v + static_cast<long long>(kk) * C + i * G + j, vv[kk][i]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] += uk[kk] * vv[kk][i][e];
      }
    }
  } else {
    for (int kk = 0; kk < K; ++kk) {
      const float uk = load_bf16_in_order(u + static_cast<long long>(n) * K + kk);
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) {
        float vv[4];
        load4_in_order(v + static_cast<long long>(kk) * C + i * G + j, vv);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] += uk * vv[e];
      }
    }
  }
}

inline bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Whether a vector kernel can take a launch (the rule of
// ops/quant.py::quant_plan): the packed bytes of a row, C / per_byte, a
// multiple of kVecBytes; base, its output and x (quant; nullptr for
// dequant) 16-byte aligned, v 8-byte aligned (its 8-byte loads), packed
// 4-byte aligned (one word a thread)
inline bool vec_plan_ok(int C, int per_byte, const void* packed, const void* base, const void* out,
                        const void* v, const void* x) {
  return C % per_byte == 0 && (C / per_byte) % kVecBytes == 0 && aligned(base, 16) && aligned(out, 16) &&
         aligned(v, 8) && aligned(packed, 4) && (x == nullptr || aligned(x, 16));
}

// the grid of a vector kernel: N * C / per_byte / kVecBytes threads
inline unsigned int vec_blocks(int N, int C, int per_byte) {
  const long long total = static_cast<long long>(N) * (C / per_byte / kVecBytes);
  return static_cast<unsigned int>((total + kVecThreads - 1) / kVecThreads);
}

// one thread per packed byte: N * C / per_byte threads
inline unsigned int n_blocks(int N, int C, int per_byte) {
  const long long total = static_cast<long long>(N) * (C / per_byte);
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace cfq
