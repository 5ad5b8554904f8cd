// The fused ring kernels, one flash launch per ring hop, each folding its
// hop into a running fp32 online-softmax state (m, l, acc) in device
// memory; the last hop normalises and writes out (in the input dtype, bf16
// or fp32) and LSE (fp32, natural log).  fp32 q/k/v take the same bodies
// in 3xTF32 (flash_reg.cuh's note; ring_flash_hop_reg_f32_kernel, entry
// cf_ring_flash_hop with f32; above d = 128 ring_flash_hop_wide_f32_kernel),
// and the EF pass then writes fp32 reconstructions
// (ef_update_fp32_f32rec_kernel, ef_codes_int8_f32rec_kernel), not rounded,
// as ring_flash_pallas.py rounds them to the activation dtype.
//
// Replaces: compactfusion_tpu/ops/ring_flash_pallas.py
//  * ring_flash_attn_with_lse (_ring_kernel, pallas_call at :347): the
//    uncompressed ring, here ring_flash_hop_reg_kernel (ring_flash_hop_wide_kernel
//    for head dims above 128);
//  * compact_binary_ring_flash (_cring_kernel, pallas_call at :954): the
//    compressed ring, here two launches per hop in stream order: the EF pass
//    (ef_update_fp32_kernel, or ef_minmax_int8_kernel then
//    ef_codes_int8_kernel): dequant of the packed payload (1-bit signs, INT2
//    sign+magnitude, or LOW_RANK u.v) and the EF update of the source slot
//    in place, with a copy of the reconstruction in the activation dtype;
//    then kernel 7's hop on that copy (the local exact K/V at hop 0).
// The TPU kernels move K/V or the payload between chips by RDMA inside one
// launch, with entry and neighbour fences.  Here the host exchanges the
// next hop's block (torch.distributed, two-sided, so ordered by itself)
// while this hop's launches run, and no fence is needed.
//
// What bounds them on an H100: the flash partial, as for flash_attn.cu
// (~4*Sq*Sk*d FLOPs per head on ~8*S*d bytes, bound by math).  The EF pass
// is memory: it reads and writes the source slot of both stacks (N*C fp32
// each at ring 2 B2: ~19 MB) and writes the bf16 copy (~5 MB), ~7 us at
// 3.35 TB/s.
//
// Design:
//  * kernel 7 is kernel 1's body with CARRY: one CTA per (q-tile, head,
//    batch), the state of its rows loaded before and stored after the K/V
//    loop.  Head dims up to 128 take, on bf16, the wgmma body
//    (flash_wgmma.cuh, ring_flash_hop_wgmma_kernel in flash_wgmma.cu), and on
//    fp32 the register body (flash_reg.cuh, ring_flash_hop_reg_kernel here),
//    with the tile height ops/flash.py::flash_plan picks; wider ones the
//    wide body (flash_wide.cuh, ring_flash_hop_wide_kernel: the head dim
//    over warps, and above d = 512 over the CTAs of a cluster);
//  * the EF pass is its own launch over tiles of 32 channels x 64 rows of
//    the slot (K and V on the grid's z): hundreds of CTAs (1,152 at ring 2
//    B2).  With residual 1 the reconstruction IS the slot's new base, which
//    is written in place; each element is read and written by one thread,
//    so no reader of an element runs after its write.  The flash partial
//    reads only the bf16 copy, which the next hop's pass overwrites in
//    stream order;
//  * int8 EF bases (B == 1): the per-channel min and max over the N rows
//    are taken across CTAs in two stages (per tile in pass 1, the tiles
//    reduced in pass 2; min and max are exact in any order, so the bits are
//    those of one serial loop); then the codes, then the new bf16 scale and
//    min, as codecs.encode_int8 computes them (the scale's division by 255
//    a true division).  Pass 2 decodes with the old scale and min from a
//    copy pass 1 took, so it can write the new ones in place;
//  * the EF stacks are read and written in their own (R, N, C) layout, a
//    head being a column block of C (the TPU wrapper transposed the whole
//    stack in and out on every call);
//  * bit-exactness: scales enter as bf16; the scale u.v is summed over k in
//    order, each term an exact bf16 x bf16 product, and val * s is exact
//    (val in {+-1, +-0.5, +-2}), so FMA contraction changes nothing; the
//    int8 decode q * scale is exact too.  The explicit _rn intrinsics keep
//    the remaining rounding steps as the plain twin takes them.

#include "flash_wide.cuh"

namespace {

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
ring_flash_hop_reg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                          int Sk, int D, float scale_log2, Carry carry) {
  flash_reg_tile<__nv_bfloat16, DP, NWARPS, true>(q, k, v, sq, sk, sv, out, lse, Sk, H, Sq, D,
                                                  scale_log2, blockIdx.x * 16 * NWARPS, blockIdx.y,
                                                  blockIdx.z, carry);
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
ring_flash_hop_reg_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                              float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                              int D, float scale_log2, Carry carry) {
  flash_reg_tile<float, DP, NWARPS, true>(q, k, v, sq, sk, sv, out, lse, Sk, H, Sq, D, scale_log2,
                                          blockIdx.x * 16 * NWARPS, blockIdx.y, blockIdx.z, carry);
}

// kernels 7 and 8's hop on the wide body: CTA part (the cluster rank) of the
// query tile blockIdx.x / parts holds the columns [part DP, (part + 1) DP)
template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
ring_flash_hop_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                           int Sk, int D, float scale_log2, Carry carry) {
  using L = WideLayout<DP, NWARPS, 2, true>;
  flash_wide_tile<__nv_bfloat16, DP, NWARPS, false, true, true>(
      q, k, v, sq, sk, sv, out, lse, Sk, H, Sq, D, scale_log2, blockIdx.x / cluster_size() * 16 * L::kGroups,
      blockIdx.y, blockIdx.z, carry);
}

template <int DP, int NWARPS>
__global__ void __launch_bounds__(32 * NWARPS)
ring_flash_hop_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                               float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                               int D, float scale_log2, Carry carry) {
  using L = WideLayout<DP, NWARPS, 4, true>;
  flash_wide_tile<float, DP, NWARPS, false, true, true>(
      q, k, v, sq, sk, sv, out, lse, Sk, H, Sq, D, scale_log2, blockIdx.x / cluster_size() * 16 * L::kGroups,
      blockIdx.y, blockIdx.z, carry);
}

// The EF pass of kernel 8: one hop's payload applied to the source slot of
// both EF stacks (K at [0], V at [1]).
struct SlotArgs {
  const uint8_t* packed[2];     // (B, H, Sk, D/8 or D/4) per-head grouped codes; null for LOW_RANK
  const __nv_bfloat16* u[2];    // (N, K) scale rows
  const __nv_bfloat16* vcol[2]; // (K, C) scale columns
  void* base[2];                // slot src: (N, C) fp32, or (N, C) uint8 codes
  __nv_bfloat16* bscale[2];     // slot src (1, C) bf16 int8 scale, or null
  __nv_bfloat16* bmin[2];       // slot src (1, C) bf16 int8 minimum, or null
  void* rec[2];                 // (N, C) = (B, Sk, H, D) reconstruction (bf16 or fp32), or null (hop 0)
  float* part;                  // int8: (2, row tiles, 2, C) each tile's min and max per channel
  __nv_bfloat16* snap;          // int8: (2, 2, C) the slot's old scale and min
  int rank;                     // K
  int N, C, Sk, H, D;
  int codec;  // 0 binary, 1 int2, 2 lowrank
};

// One CTA of the EF pass takes a tile of kEfCols channels by kEfRows rows:
// a warp per row lane, its 32 threads on 32 neighbouring channels.  Keep
// kEfRows equal to ops/ring_flash.py::EF_ROWS (the int8 scratch's size).
constexpr int kEfCols = 32;
constexpr int kEfLanes = 8;
constexpr int kEfRows = 64;

// The pointers of K (w = 0) or V (1), picked without indexing the kernel's
// parameter arrays by a runtime value (which would copy them to local memory)
struct SlotOf {
  const uint8_t* packed;
  const __nv_bfloat16* u;
  const __nv_bfloat16* vcol;
  void* base;
  __nv_bfloat16* bscale;
  __nv_bfloat16* bmin;
  void* rec;
};

__device__ __forceinline__ SlotOf slot_of(const SlotArgs& a, int w) {
  const bool v = w != 0;
  return SlotOf{v ? a.packed[1] : a.packed[0], v ? a.u[1] : a.u[0],      v ? a.vcol[1] : a.vcol[0],
                v ? a.base[1] : a.base[0],     v ? a.bscale[1] : a.bscale[0],
                v ? a.bmin[1] : a.bmin[0],     v ? a.rec[1] : a.rec[0]};
}

// What a thread's column fixes of its elements' addresses: the head, the
// channel within it, and the byte and bit offset of its code
struct ColOf {
  int col, h, byte_col, shift;
};

__device__ __forceinline__ ColOf col_of(const SlotArgs& a, int col) {
  const int h = col / a.D, dd = col % a.D;
  const int g = a.codec == 1 ? a.D / 4 : a.D / 8;  // code bytes per row of a head
  return ColOf{col, h, dd % g, (a.codec == 1 ? 2 : 1) * (dd / g)};
}

// base + delta of element (row, c.col) of the slot: the reconstruction,
// which is also the slot's new EF base.  int8 bases decode with the given
// scale and min (null: fp32 bases).
__device__ __forceinline__ float reconstruct(const SlotArgs& a, const SlotOf& p, const ColOf& c,
                                             int row, const __nv_bfloat16* scale,
                                             const __nv_bfloat16* minv) {
  const __nv_bfloat16* u = p.u + static_cast<long long>(row) * a.rank;
  const __nv_bfloat16* vc = p.vcol + c.col;
  float s = __fmul_rn(__bfloat162float(u[0]), __bfloat162float(vc[0]));
  for (int i = 1; i < a.rank; ++i) {
    s = __fadd_rn(s, __fmul_rn(__bfloat162float(u[i]), __bfloat162float(vc[static_cast<long long>(i) * a.C])));
  }
  float delta = s;
  if (a.codec != 2) {
    const int b = row / a.Sk, n = row - b * a.Sk;
    const int g = a.codec == 1 ? a.D / 4 : a.D / 8;
    const uint8_t byte = p.packed[((static_cast<long long>(b) * a.H + c.h) * a.Sk + n) * g + c.byte_col];
    if (a.codec == 0) {
      delta = ((byte >> c.shift) & 1) ? s : -s;
    } else {
      const int code = (byte >> c.shift) & 3;
      const float val = (code >= 2 ? 1.f : -1.f) * ((code & 1) ? 2.f : 0.5f);
      delta = __fmul_rn(val, s);
    }
  }
  const long long idx = static_cast<long long>(row) * a.C + c.col;
  float base;
  if (scale != nullptr) {
    const uint8_t q = static_cast<const uint8_t*>(p.base)[idx];
    base = __fadd_rn(__fmul_rn(static_cast<float>(q), __bfloat162float(scale[c.col])),
                     __bfloat162float(minv[c.col]));
  } else {
    base = static_cast<const float*>(p.base)[idx];
  }
  return __fadd_rn(base, delta);
}

// The rows of this thread in its CTA's tile, each below N: row(i) for i in
// [0, kEfRows / kEfLanes), unrolled so their loads are in flight together
constexpr int kEfRowsPerThread = kEfRows / kEfLanes;
__device__ __forceinline__ int tile_row(int i) { return blockIdx.y * kEfRows + threadIdx.y + i * kEfLanes; }

// The reconstruction in the activation dtype: rounded to bf16, or as it is
__device__ __forceinline__ void put_rec(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put_rec(float* p, float x) { *p = x; }

// fp32 bases: every element is read, rebuilt and written back in place by
// one thread, and its copy in the activation dtype R goes to rec after hop 0
template <typename R>
__device__ __forceinline__ void ef_update_fp32(const SlotArgs& a) {
  const int col = blockIdx.x * kEfCols + threadIdx.x;
  if (col >= a.C) return;
  const SlotOf p = slot_of(a, blockIdx.z);
  const ColOf c = col_of(a, col);
  float* base = static_cast<float*>(p.base);
  R* rec = static_cast<R*>(p.rec);
#pragma unroll
  for (int i = 0; i < kEfRowsPerThread; ++i) {
    const int row = tile_row(i);
    if (row >= a.N) break;
    const float blk = reconstruct(a, p, c, row, nullptr, nullptr);
    const long long idx = static_cast<long long>(row) * a.C + col;
    base[idx] = blk;
    if (rec != nullptr) put_rec(rec + idx, blk);
  }
}

__global__ void __launch_bounds__(kEfCols * kEfLanes) ef_update_fp32_kernel(SlotArgs a) {
  ef_update_fp32<__nv_bfloat16>(a);
}

__global__ void __launch_bounds__(kEfCols * kEfLanes) ef_update_fp32_f32rec_kernel(SlotArgs a) {
  ef_update_fp32<float>(a);
}

// int8 bases, pass 1: each tile's min and max of the new block per channel
// (a thread over its rows, then the CTA's row lanes), into part; the CTAs
// of the first row tile also copy the slot's old scale and min into snap,
// which pass 2 decodes with while it writes the new ones in place
__global__ void __launch_bounds__(kEfCols * kEfLanes) ef_minmax_int8_kernel(SlotArgs a) {
  __shared__ float lo[kEfLanes][kEfCols], hi[kEfLanes][kEfCols];
  const int w = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kEfCols + tx;
  const SlotOf p = slot_of(a, w);
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  if (col < a.C) {
    const ColOf c = col_of(a, col);
#pragma unroll
    for (int i = 0; i < kEfRowsPerThread; ++i) {
      const int row = tile_row(i);
      if (row >= a.N) break;
      const float blk = reconstruct(a, p, c, row, p.bscale, p.bmin);
      mn = fminf(mn, blk);
      mx = fmaxf(mx, blk);
    }
  }
  lo[ty][tx] = mn;
  hi[ty][tx] = mx;
  __syncthreads();
  if (ty != 0 || col >= a.C) return;
  for (int i = 1; i < kEfLanes; ++i) {
    mn = fminf(mn, lo[i][tx]);
    mx = fmaxf(mx, hi[i][tx]);
  }
  float* part = a.part + (static_cast<long long>(w) * gridDim.y + blockIdx.y) * 2 * a.C;
  part[col] = mn;
  part[a.C + col] = mx;
  if (blockIdx.y == 0) {
    a.snap[(2 * w) * a.C + col] = p.bscale[col];
    a.snap[(2 * w + 1) * a.C + col] = p.bmin[col];
  }
}

// int8 bases, pass 2: the tiles' min and max reduced per channel (exact in
// any order), then the codes with the scale's true division by 255, as
// codecs.encode_int8 takes them (each element read, then written, by one
// thread; the old scale and min read from snap); the first row tile writes
// the new scale and min in place; the reconstruction goes to rec in the
// activation dtype R
template <typename R>
__device__ __forceinline__ void ef_codes_int8(const SlotArgs& a) {
  __shared__ float mn_s[kEfCols], sc_s[kEfCols];
  const int w = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kEfCols + tx;
  const SlotOf p = slot_of(a, w);
  if (ty == 0 && col < a.C) {
    const float* part = a.part + static_cast<long long>(w) * gridDim.y * 2 * a.C;
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    for (int t = 0; t < static_cast<int>(gridDim.y); ++t) {
      mn = fminf(mn, part[2 * t * a.C + col]);
      mx = fmaxf(mx, part[(2 * t + 1) * a.C + col]);
    }
    const float sc = __fdiv_rn(__fadd_rn(__fsub_rn(mx, mn), 1e-6f), 255.f);
    mn_s[tx] = mn;
    sc_s[tx] = sc;
    if (blockIdx.y == 0) {
      p.bscale[col] = __float2bfloat16(sc);
      p.bmin[col] = __float2bfloat16(mn);
    }
  }
  __syncthreads();
  if (col >= a.C) return;
  const float mn = mn_s[tx], sc = sc_s[tx];
  const __nv_bfloat16* old = a.snap + 2 * w * a.C;
  uint8_t* codes = static_cast<uint8_t*>(p.base);
  R* rec = static_cast<R*>(p.rec);
  const ColOf c = col_of(a, col);
#pragma unroll
  for (int i = 0; i < kEfRowsPerThread; ++i) {
    const int row = tile_row(i);
    if (row >= a.N) break;
    const float blk = reconstruct(a, p, c, row, old, old + a.C);
    const float code = fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(blk, mn), sc)), 0.f), 255.f);
    const long long idx = static_cast<long long>(row) * a.C + col;
    codes[idx] = static_cast<uint8_t>(code);
    if (rec != nullptr) put_rec(rec + idx, blk);
  }
}

__global__ void __launch_bounds__(kEfCols * kEfLanes) ef_codes_int8_kernel(SlotArgs a) {
  ef_codes_int8<__nv_bfloat16>(a);
}

__global__ void __launch_bounds__(kEfCols * kEfLanes) ef_codes_int8_f32rec_kernel(SlotArgs a) {
  ef_codes_int8<float>(a);
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// A hop on the wide body of T elements, on clusters of `parts` CTAs
template <typename T, int DP, int NWARPS>
int launch_ring_hop_wide(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv, T* out,
                         float* lse, int B, int Sq, int Sk, int H, int D, float scale_log2, Carry carry,
                         int parts, cudaStream_t stream) {
  using L = WideLayout<DP, NWARPS, static_cast<int>(sizeof(T)), true>;
  constexpr int BQ = 16 * L::kGroups;
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return ring_flash_hop_wide_f32_kernel<DP, NWARPS>;
    else return ring_flash_hop_wide_kernel<DP, NWARPS>;
  }();
  return launch_split(kern, parts, dim3((Sq + BQ - 1) / BQ, H, B), 32 * NWARPS, L::kBytes, stream, q, k, v, sq,
                      sk, sv, out, lse, H, Sq, Sk, D, scale_log2, carry);
}

template <typename T, int DP, int NWARPS>
int launch_ring_hop_reg(const T* q, const T* k, const T* v, Strides sq, Strides sk, Strides sv,
                        T* out, float* lse, int B, int Sq, int Sk, int H, int D, float scale_log2,
                        Carry carry, cudaStream_t stream) {
  constexpr int BQ = 16 * NWARPS, BYTES = RegLayout<DP, NWARPS, static_cast<int>(sizeof(T))>::kBytes;
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return ring_flash_hop_reg_f32_kernel<DP, NWARPS>;
    else return ring_flash_hop_reg_kernel<DP, NWARPS>;
  }();
  if (int e = set_smem(kern, BYTES)) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, 32 * NWARPS, BYTES, stream>>>(q, k, v, sq, sk, sv, out, lse, H, Sq, Sk, D, scale_log2,
                                             carry);
  return static_cast<int>(cudaGetLastError());
}

// One hop at the plan (body, dp, warps) on T elements: the register body at
// a built (dp, warps) with D <= dp, or the wide body on clusters of
// wide_parts(dp) CTAs, each at (dp / parts, warps), one of CF_WIDE_PLANS;
// anything else is an error
template <typename T>
int ring_hop(const void* q, const void* k, const void* v, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh, long long vsb, long long vss,
             long long vsh, void* m, void* l, void* acc, void* out, void* lse, int B, int Sq, int Sk,
             int H, int D, float scale, int first, int last, int body, int dp, int warps,
             void* stream) {
  const cudaError_t refused = cudaErrorInvalidValue;
  if (D % 8 != 0 || D > dp) return static_cast<int>(refused);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Carry carry{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
                    first, last};
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  auto* lp = static_cast<float*>(lse);
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  if (body == kRegBody) {
#define CF_REG_CASE(DPV, W)                                                                         \
  if (dp == DPV && warps == W) {                                                                     \
    return launch_ring_hop_reg<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, Sk, H, D, sl2, carry, \
                                          st);                                                       \
  }
    CF_REG_PLANS(CF_REG_CASE)
#undef CF_REG_CASE
    return static_cast<int>(refused);
  }
  const int parts = wide_parts(dp);
  if (body != kWideBody || parts == 0 || D <= (parts - 1) * (dp / parts)) return static_cast<int>(refused);
#define CF_WIDE_CASE(DPV, W)                                                                                    \
  if (dp / parts == DPV && warps == W) {                                                                         \
    return launch_ring_hop_wide<T, DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, Sk, H, D, sl2, carry, parts, st); \
  }
  CF_WIDE_PLANS(CF_WIDE_CASE)
#undef CF_WIDE_CASE
  return static_cast<int>(refused);
}

}  // namespace

// One hop of the uncompressed ring: q (B, Sq, H, D) against this hop's
// k/v (B, Sk, H, D), folded into the state m, l (B, H, Sq), acc (B, H, Sq, D),
// with the plan (body, dp, warps) of ops/flash.py::flash_plan: the register
// body at a built (dp, warps) with D <= dp, or the wide body (ring_hop's
// note); anything else is an error.
// bf16 q/k/v and out, or fp32 ones with f32.
extern "C" int cf_ring_flash_hop(const void* q, const void* k, const void* v,
                                 long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh,
                                 long long vsb, long long vss, long long vsh,
                                 void* m, void* l, void* acc, void* out, void* lse,
                                 int B, int Sq, int Sk, int H, int D, float scale,
                                 int first, int last, int body, int dp, int warps, int f32,
                                 void* stream) {
  auto run = f32 ? ring_hop<float> : ring_hop<__nv_bfloat16>;
  return run(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, m, l, acc, out, lse, B, Sq, Sk, H,
             D, scale, first, last, body, dp, warps, stream);
}

// The EF pass of one hop of the compressed ring (kernel 8's flash partial
// is cf_ring_flash_hop on its output).  pk/pv: per-head packed codes
// (null for LOW_RANK); uk/uv (N, K), vk/vv (K, C) bf16 scales; kb/vb the
// source slot of the EF stacks, (N, C) fp32, or uint8 codes with ks/km,
// vs/vm its (1, C) bf16 scale and min when quantized (then B == 1, and
// part (2, part_rows, 2, C) fp32 with part_rows = ceil(N / kEfRows) and
// snap (2, 2, C) bf16 are scratch); rec_k/rec_v (B, Sk, H, D) bf16 (fp32
// with rec_f32) for the reconstruction, or null (hop 0); codec 0 binary,
// 1 int2, 2 lowrank.  Launches one kernel on fp32 bases, two on int8 bases.
extern "C" int cf_ef_update_slot(const void* pk, const void* pv, const void* uk, const void* uv,
                                 const void* vk, const void* vv, int rank, void* kb, void* ks,
                                 void* km, void* vb, void* vs, void* vm, void* rec_k, void* rec_v,
                                 void* part, void* snap, int part_rows, int B, int Sk, int H,
                                 int D, int codec, int quantized, int rec_f32, void* stream) {
  const int N = B * Sk, C = H * D;
  const int row_tiles = (N + kEfRows - 1) / kEfRows;
  if (N == 0 || C == 0) return 0;
  if (codec < 0 || codec > 2 || rank < 1 || D % 8 != 0 ||
      (codec != 2 && (pk == nullptr || pv == nullptr)) || ((rec_k == nullptr) != (rec_v == nullptr)) ||
      (quantized && (B != 1 || ks == nullptr || km == nullptr || vs == nullptr || vm == nullptr ||
                     part == nullptr || snap == nullptr || part_rows != row_tiles))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlotArgs a;
  a.packed[0] = static_cast<const uint8_t*>(pk);
  a.packed[1] = static_cast<const uint8_t*>(pv);
  a.u[0] = static_cast<const __nv_bfloat16*>(uk);
  a.u[1] = static_cast<const __nv_bfloat16*>(uv);
  a.vcol[0] = static_cast<const __nv_bfloat16*>(vk);
  a.vcol[1] = static_cast<const __nv_bfloat16*>(vv);
  a.base[0] = kb;
  a.base[1] = vb;
  a.bscale[0] = static_cast<__nv_bfloat16*>(ks);
  a.bscale[1] = static_cast<__nv_bfloat16*>(vs);
  a.bmin[0] = static_cast<__nv_bfloat16*>(km);
  a.bmin[1] = static_cast<__nv_bfloat16*>(vm);
  a.rec[0] = rec_k;
  a.rec[1] = rec_v;
  a.part = static_cast<float*>(part);
  a.snap = static_cast<__nv_bfloat16*>(snap);
  a.rank = rank;
  a.N = N;
  a.C = C;
  a.Sk = Sk;
  a.H = H;
  a.D = D;
  a.codec = codec;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kEfCols - 1) / kEfCols, row_tiles, 2), block(kEfCols, kEfLanes);
  if (!quantized) {
    if (rec_f32) ef_update_fp32_f32rec_kernel<<<grid, block, 0, st>>>(a);
    else ef_update_fp32_kernel<<<grid, block, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  ef_minmax_int8_kernel<<<grid, block, 0, st>>>(a);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  if (rec_f32) ef_codes_int8_f32rec_kernel<<<grid, block, 0, st>>>(a);
  else ef_codes_int8_kernel<<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
