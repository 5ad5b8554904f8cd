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
// Quant has two kernels; ops/quant.py::binary_quant_plan picks one before
// the launch and the C entry launches exactly that:
//  * the vector kernel (kVecBytes packed bytes per thread), where C/8 is a
//    multiple of kVecBytes and x, base and v start 16-byte aligned: thread
//    (n, j) takes bytes j..j+3 of row n, so each of its 8 bit groups is 4
//    consecutive channels: one 16-byte load of x and of base (8 bytes for
//    bf16) and one store of the new base per group, neighbouring threads on
//    neighbouring 16 bytes, and one 4-byte store of the packed bytes.  All
//    16 loads of x and base are issued before any is used, and the grid is
//    kVecThreads-thread CTAs (144 at N256 C1152, one per SM), so the whole
//    call's bytes are in flight at once against the DRAM latency.  u[n, :]
//    is read once per row and k, v[k, c..c+3] as one 8-byte load;
//  * the scalar kernel for the other shapes and views: one thread per packed
//    byte (n, j), its 8 channels read one by one, the scale read per element.
// Dequant keeps the scalar form (one thread per byte).

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

// packed bytes per thread and threads per CTA of the vector quant kernel
// (ops/quant.py::QUANT_VEC_BYTES)
constexpr int kVecBytes = 4;
constexpr int kVecThreads = 64;

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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TB>
void dequant(const void* packed, const void* base, const void* u, const void* v, void* out,
             int N, int C, int K, cudaStream_t st) {
  binary_dequant_kernel<TB><<<cfq::n_blocks(N, C, 8), cfq::kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<const TB*>(base),
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
      static_cast<TB*>(out), N, C, K);
}

}  // namespace

// vec: the plan, packed bytes per thread: 1 (the scalar kernel) or kVecBytes
// (the vector kernel, which needs C % (8 * kVecBytes) == 0 and 16-byte
// aligned x, base, v and new_base); anything else is an error
extern "C" int cf_binary_quant(const void* x, const void* base, const void* u, const void* v,
                               void* packed, void* new_base, int N, int C, int K, int x_bf16,
                               int base_bf16, int vec, void* stream) {
  const bool vec_ok = C % (8 * kVecBytes) == 0 && aligned16(x) && aligned16(base) && aligned16(v) &&
                      aligned16(new_base) && aligned16(packed);
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
