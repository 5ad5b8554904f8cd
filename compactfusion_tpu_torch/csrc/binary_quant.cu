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
// the ring-8 PixArt shape (N=256, C=1152) the whole call moves ~3.5 MB
// (1.07 us at 3.35 TB/s) and is as short as a launch.  Dequant moves ~8
// bytes per element.
//
// The wire layout is the grouped one of compact/packing.py: bit i of byte j
// of a row is channel i*(C/8)+j.  scale[n, c] = sum_k u[n, k] * v[k, c] is
// formed in fp32 in the same k order (each term an exact bf16 x bf16
// product) by every kernel, so quant's new base equals dequant's output bit
// for bit (the error-feedback consistency invariant the ring emulation
// relies on).  delta >= 0 maps to +1, -0.0 included.  Needs C % 8 == 0; any
// N.
//
// Quant and dequant have two kernels each; ops/quant.py::quant_plan picks
// one before the launch (the rule of quant_common.cuh::vec_plan_ok) and the C
// entry launches exactly that:
//  * the vector kernel (kVecBytes packed bytes per thread), where C/8 is a
//    multiple of kVecBytes and the operands start aligned for their
//    accesses: thread (n, j) takes bytes j..j+3 of row n, so each of its 8
//    bit groups is 4 consecutive channels: one 16-byte load of x and of
//    base (8 bytes for bf16) and one store of the result per group,
//    neighbouring threads on neighbouring 16 bytes, and one 4-byte access
//    of the packed bytes.  Every load of a thread is issued before any is
//    used, and the grid is kVecThreads-thread CTAs (144 at N256 C1152, one
//    per SM), so the whole call's bytes are in flight at once against the
//    DRAM latency.  u[n, :] is read once per row and k, v[k, c..c+3] as
//    one 8-byte load.  Dequant (binary_dequant_vec_kernel) has no x: its
//    loads are the packed word, the 8 base vectors and, with K a template
//    argument (1 and 2, the path's), every u and v value (vec_scales), all
//    issued in order before the first store (quant_common.cuh's in-order
//    loads): one DRAM round trip a thread;
//  * the scalar kernel for the other shapes and views: one thread per packed
//    byte (n, j), its 8 channels read one by one, the scale read per element.

#include "quant_common.cuh"

namespace {

using cfq::from_f;
using cfq::kVecBytes;
using cfq::kVecThreads;
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

template <typename TX, typename TB>
__global__ void __launch_bounds__(kVecThreads)
binary_quant_vec_kernel(const TX* __restrict__ x, const TB* __restrict__ base,
                        const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ v,
                        uint8_t* __restrict__ packed, TB* __restrict__ new_base, int N, int C,
                        int K) {
  const int G = C / 8, per_row = G / kVecBytes;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(idx / per_row);
  const int j = static_cast<int>(idx % per_row) * kVecBytes;
  const long long at = static_cast<long long>(n) * C + j;  // channel j of row n: group 0
  float xs[8][4], bs[8][4], sc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cfq::load4(x + at + i * G, xs[i]);
    cfq::load4(base + at + i * G, bs[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
  }
  for (int kk = 0; kk < K; ++kk) {  // the scale, k ascending, as scale_at sums it
    const float uk = __bfloat162float(u[static_cast<long long>(n) * K + kk]);
    const __nv_bfloat16* vk = v + static_cast<long long>(kk) * C + j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float vv[4];
      cfq::load4(vk + i * G, vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] += uk * vv[e];
    }
  }
  unsigned int word = 0u;  // byte j + e of the row is bits [8e, 8e + 8)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float nb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool pos = xs[i][e] - bs[i][e] >= 0.f;
      word |= static_cast<unsigned int>(pos) << (8 * e + i);
      nb[e] = bs[i][e] + (pos ? sc[i][e] : -sc[i][e]);
    }
    cfq::store4(new_base + at + i * G, nb);
  }
  *reinterpret_cast<uint32_t*>(packed + static_cast<long long>(n) * G + j) = word;
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

// The vector form of binary_dequant_kernel: thread (n, j) takes packed
// bytes j..j+3 of row n (quant_common.cuh); KT is K where it is 1 or 2, else
// 0 (a runtime loop over K).  out = base + (bit ? s : -s) as the scalar
// kernel and both quant kernels form it, so every plan of either side
// rebuilds the same new base bit for bit.  Every load goes through the
// in-order loads of quant_common.cuh and no pointer is __restrict__, so all
// 18 loads of a thread (27 at K = 2) lead its first store: one DRAM round
// trip.
template <typename TB, int KT>
__global__ void __launch_bounds__(kVecThreads)
binary_dequant_vec_kernel(const uint8_t* packed, const TB* base, const __nv_bfloat16* u,
                          const __nv_bfloat16* v, TB* out, int N, int C, int K) {
  const int G = C / 8, per_row = G / kVecBytes;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * per_row) return;
  const int n = static_cast<int>(idx / per_row);
  const int j = static_cast<int>(idx % per_row) * kVecBytes;
  const long long at = static_cast<long long>(n) * C + j;  // channel j of row n: group 0
  const uint32_t word = cfq::load_packed(packed + static_cast<long long>(n) * G + j);
  float bs[8][4], sc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) cfq::load4_in_order(base + at + i * G, bs[i]);
  cfq::vec_scales<8, KT>(u, v, n, j, G, C, K, sc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = bs[i][e] + (((word >> (8 * e + i)) & 1u) ? sc[i][e] : -sc[i][e]);
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
    const long long threads = static_cast<long long>(N) * (C / 8 / kVecBytes);
    const auto blocks = static_cast<unsigned int>((threads + kVecThreads - 1) / kVecThreads);
    binary_quant_vec_kernel<TX, TB><<<blocks, kVecThreads, 0, st>>>(xp, bp, up, vp, pp, np, N, C, K);
  } else {
    binary_quant_kernel<TX, TB><<<cfq::n_blocks(N, C, 8), cfq::kThreads, 0, st>>>(xp, bp, up, vp, pp,
                                                                                   np, N, C, K);
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
    const unsigned int blocks = cfq::vec_blocks(N, C, 8);
    if (K == 1) {
      binary_dequant_vec_kernel<TB, 1><<<blocks, kVecThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
    } else if (K == 2) {
      binary_dequant_vec_kernel<TB, 2><<<blocks, kVecThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
    } else {
      binary_dequant_vec_kernel<TB, 0><<<blocks, kVecThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
    }
  } else {
    binary_dequant_kernel<TB><<<cfq::n_blocks(N, C, 8), cfq::kThreads, 0, st>>>(pp, bp, up, vp, op, N, C, K);
  }
}

}  // namespace

// vec: the plan, packed bytes per thread: 1 (the scalar kernel) or kVecBytes
// (the vector kernel, where cfq::vec_plan_ok holds); anything else is an
// error
extern "C" int cf_binary_quant(const void* x, const void* base, const void* u, const void* v,
                               void* packed, void* new_base, int N, int C, int K, int x_bf16,
                               int base_bf16, int vec, void* stream) {
  const bool vec_ok = cfq::vec_plan_ok(C, 8, packed, base, new_base, v, x);
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

// vec: the plan, as cf_binary_quant takes it
extern "C" int cf_binary_dequant(const void* packed, const void* base, const void* u,
                                 const void* v, void* out, int N, int C, int K, int base_bf16,
                                 int vec, void* stream) {
  const bool vec_ok = cfq::vec_plan_ok(C, 8, packed, base, out, v, nullptr);
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
