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
// Design: quant and dequant have two kernels each; ops/quant.py::quant_plan
// picks one before the launch (the rule of quant_common.cuh::vec_plan_ok) and
// the C entry launches exactly that:
//  * the vector kernel (int2_quant_vec_kernel, int2_dequant_vec_kernel),
//    where C/4 is a multiple of kVecBytes and the operands start aligned:
//    thread (n, j) takes packed bytes j..j+3 of row n (one 4-byte access),
//    so each of its 4 crumb groups is 4 consecutive channels: one 16-byte
//    access of x, base and the result each (8 bytes for bf16).  Every load
//    (quant: the 4 x and 4 base vectors; dequant: the word and the 4 base
//    vectors; both: u and v with K a template argument) is issued in order
//    before the first store: one DRAM round trip a thread, 288 CTAs of 64
//    at N256 C1152;
//  * the scalar kernel (int2_quant_kernel, int2_dequant_kernel), one thread
//    per packed byte (n, j) and its 4 channels i*(C/4)+j of the grouped wire
//    layout (crumb i of byte j, see compact/packing.py), one after another,
//    for the other shapes and views.
// Every kernel forms the scale as scale_at does and the new base as base +
// int2_step * s, so dequant on either plan rebuilds quant's new base on
// either plan bit for bit: the error-feedback consistency invariant.  Needs
// C % 4 == 0; any N (the ragged edge is masked).

#include "quant_common.cuh"

namespace {

using cfq::from_f;
using cfq::kVecBytes;
using cfq::kVecThreads;
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

// The vector form of int2_quant_kernel (see the file's note): the layout of
// int2_dequant_vec_kernel run forward, KT as there.  code = 2 * (delta >= 0)
// + (|delta| beyond s) per channel, crumb i of byte j + e in bits 8e + 2i of
// the word.  The in-order loads and no __restrict__ keep all of a thread's
// loads (13 at K = 1: 4 x, 4 base, u, 4 v) ahead of its first store.
template <typename TX, typename TB, int KT>
__global__ void __launch_bounds__(kVecThreads)
int2_quant_vec_kernel(const TX* x, const TB* base, const __nv_bfloat16* u, const __nv_bfloat16* v,
                      uint8_t* packed, TB* new_base, int N, int C, int K) {
  const int G = C / 4, per_row = G / kVecBytes;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(idx / per_row);
  const int j = static_cast<int>(idx % per_row) * kVecBytes;
  const long long at = static_cast<long long>(n) * C + j;  // channel j of row n: group 0
  float xs[4][4], bs[4][4], sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cfq::load4_in_order(x + at + i * G, xs[i]);
    cfq::load4_in_order(base + at + i * G, bs[i]);
  }
  cfq::vec_scales<4, KT>(u, v, n, j, G, C, K, sc);
  unsigned int word = 0u;  // byte j + e of the row is bits [8e, 8e + 8)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float nb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float delta = xs[i][e] - bs[i][e];
      const float s = sc[i][e];
      const bool pos = delta >= 0.f;
      const bool mag = (delta > s) || (delta < -s);
      word |= (2u * static_cast<unsigned int>(pos) + static_cast<unsigned int>(mag)) << (8 * e + 2 * i);
      nb[e] = bs[i][e] + int2_step(pos, mag) * s;
    }
    cfq::store4(new_base + at + i * G, nb);
  }
  *reinterpret_cast<uint32_t*>(packed + static_cast<long long>(n) * G + j) = word;
}

// The vector form of int2_dequant_kernel (see the file's note); KT is K where
// it is 1 (the path's), else 0 (a runtime loop over K).  As in
// binary_dequant_vec_kernel, the in-order loads and no __restrict__ keep
// all 10 loads of a thread ahead of its first store.
template <typename TB, int KT>
__global__ void __launch_bounds__(kVecThreads)
int2_dequant_vec_kernel(const uint8_t* packed, const TB* base, const __nv_bfloat16* u,
                        const __nv_bfloat16* v, TB* out, int N, int C, int K) {
  const int G = C / 4, per_row = G / kVecBytes;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(idx / per_row);
  const int j = static_cast<int>(idx % per_row) * kVecBytes;
  const long long at = static_cast<long long>(n) * C + j;  // channel j of row n: group 0
  const uint32_t word = cfq::load_packed(packed + static_cast<long long>(n) * G + j);
  float bs[4][4], sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cfq::load4_in_order(base + at + i * G, bs[i]);
  cfq::vec_scales<4, KT>(u, v, n, j, G, C, K, sc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned int code = (word >> (8 * e + 2 * i)) & 3u;  // crumb i of byte j + e
      o[e] = bs[i][e] + int2_step(code >= 2u, (code & 1u) != 0u) * sc[i][e];
    }
    cfq::store4(out + at + i * G, o);
  }
}

template <typename TX, typename TB>
void quant(const void* x, const void* base, const void* u, const void* v, void* packed,
           void* new_base, int N, int C, int K, int vec, cudaStream_t st) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* bp = static_cast<const TB*>(base);
  const auto* up = static_cast<const __nv_bfloat16*>(u);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* pp = static_cast<uint8_t*>(packed);
  auto* np = static_cast<TB*>(new_base);
  if (vec == kVecBytes) {
    const unsigned int blocks = cfq::vec_blocks(N, C, 4);
    if (K == 1) {
      int2_quant_vec_kernel<TX, TB, 1><<<blocks, kVecThreads, 0, st>>>(xp, bp, up, vp, pp, np, N, C, K);
    } else {
      int2_quant_vec_kernel<TX, TB, 0><<<blocks, kVecThreads, 0, st>>>(xp, bp, up, vp, pp, np, N, C, K);
    }
  } else {
    int2_quant_kernel<TX, TB><<<cfq::n_blocks(N, C, 4), cfq::kThreads, 0, st>>>(xp, bp, up, vp, pp, np, N, C, K);
  }
}

template <typename TB>
void dequant(const void* packed, const void* base, const void* u, const void* v, void* out,
             int N, int C, int K, int vec, cudaStream_t st) {
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* bp = static_cast<const TB*>(base);
  const auto* up = static_cast<const __nv_bfloat16*>(u);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<TB*>(out);
  if (vec == kVecBytes) {
    const unsigned int blocks = cfq::vec_blocks(N, C, 4);
    if (K == 1) {
      int2_dequant_vec_kernel<TB, 1><<<blocks, kVecThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
    } else {
      int2_dequant_vec_kernel<TB, 0><<<blocks, kVecThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
    }
  } else {
    int2_dequant_kernel<TB><<<cfq::n_blocks(N, C, 4), cfq::kThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
  }
}

}  // namespace

// vec: the plan, packed bytes per thread: 1 (the scalar kernel) or kVecBytes
// (the vector kernel, where cfq::vec_plan_ok holds); anything else is an
// error
extern "C" int cf_int2_quant(const void* x, const void* base, const void* u, const void* v,
                             void* packed, void* new_base, int N, int C, int K, int x_bf16,
                             int base_bf16, int vec, void* stream) {
  const bool vec_ok = cfq::vec_plan_ok(C, 4, packed, base, new_base, v, x);
  if (vec != 1 && !(vec == kVecBytes && vec_ok)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || C == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && base_bf16) {
    quant<__nv_bfloat16, __nv_bfloat16>(x, base, u, v, packed, new_base, N, C, K, vec, st);
  } else if (x_bf16) {
    quant<__nv_bfloat16, float>(x, base, u, v, packed, new_base, N, C, K, vec, st);
  } else if (base_bf16) {
    quant<float, __nv_bfloat16>(x, base, u, v, packed, new_base, N, C, K, vec, st);
  } else {
    quant<float, float>(x, base, u, v, packed, new_base, N, C, K, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// vec: the plan, as cf_int2_quant takes it
extern "C" int cf_int2_dequant(const void* packed, const void* base, const void* u,
                               const void* v, void* out, int N, int C, int K, int base_bf16,
                               int vec, void* stream) {
  const bool vec_ok = cfq::vec_plan_ok(C, 4, packed, base, out, v, nullptr);
  if (vec != 1 && !(vec == kVecBytes && vec_ok)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || C == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (base_bf16) {
    dequant<__nv_bfloat16>(packed, base, u, v, out, N, C, K, vec, st);
  } else {
    dequant<float>(packed, base, u, v, out, N, C, K, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}
