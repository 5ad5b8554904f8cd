// The fused ring kernels, one launch per ring hop, each folding its hop
// into a running fp32 online-softmax state (m, l, acc) in device memory;
// the last hop normalises and writes out (bf16) and LSE (fp32, natural log).
//
// Replaces: compactfusion_tpu/ops/ring_flash_pallas.py
//  * ring_flash_attn_with_lse (_ring_kernel, pallas_call at :347): the
//    uncompressed ring, here ring_flash_hop_kernel;
//  * compact_binary_ring_flash (_cring_kernel, pallas_call at :954): the
//    compressed ring, here compact_ring_hop_kernel: per hop, dequant of the
//    packed payload (1-bit signs, INT2 sign+magnitude, or LOW_RANK u.v),
//    the EF update of the source slot in place, and a flash partial on the
//    reconstruction (the local exact K/V at hop 0).
// The TPU kernels move K/V or the payload between chips by RDMA inside one
// launch, with entry and neighbour fences.  Here the host exchanges the
// next hop's block (torch.distributed, two-sided, so ordered by itself)
// while this hop's launch runs, and no fence is needed.
//
// What bounds them on an H100: the flash partial, as for flash_attn.cu
// (~4*Sq*Sk*d FLOPs per head on ~8*S*d bytes, bound by math).  The
// compressed hop adds an elementwise pass over the source slot of the EF
// stack (read and write Sk*d fp32 per head and K/V: memory).
//
// Design:
//  * kernel 7 is kernel 1's body with CARRY: one CTA per (q-tile, head,
//    batch), the state of its rows loaded before and stored after the K/V
//    loop.  Head dims up to 128 take the register body (flash_reg.cuh,
//    ring_flash_hop_reg_kernel) with the tile height ops/flash.py::flash_plan
//    picks (at ring 8, Sq = 128, shorter tiles fill the card), wider ones
//    the shared-memory body (ring_flash_hop_kernel);
//  * compact_ring_hop_kernel gives one CTA a whole (b, h): with residual 1
//    the reconstruction IS the new base of slot src, so a CTA that wrote
//    the slot in place while another CTA of the same (b, h) still read it
//    would add the delta twice.  The CTA first rebuilds the head's Sk x D
//    block of K and of V from base + delta, writes the new base and (after
//    hop 0) a bf16 copy of the block into a scratch (B, Sk, H, D) tensor,
//    then runs the flash body over its q-tiles in turn, reading K/V from
//    the scratch (or the exact K/V at hop 0).  That is B*H CTAs: 16-32 on
//    132 SMs at PixArt's ring 2, the first thing a perf PR should change;
//  * int8 EF bases (B == 1): the per-channel min-max over the head's Sk rows
//    comes first (one thread per channel), then codes, then the new bf16
//    scale and min, as codecs.encode_int8 computes them (the scale's
//    division by 255 a true division);
//  * the EF stacks are read and written in their own (R, N, C) layout, a
//    head being a column block of C (the TPU wrapper transposed the whole
//    stack in and out on every call);
//  * bit-exactness: scales enter as bf16; the scale u.v is summed over k in
//    order, each term an exact bf16 x bf16 product, and val * s is exact
//    (val in {+-1, +-0.5, +-2}), so FMA contraction changes nothing; the
//    int8 decode q * scale is exact too.  The explicit _rn intrinsics keep
//    the remaining rounding steps as the plain twin takes them.

#include "flash_reg.cuh"

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

template <int NWARPS, int BK>
__global__ void __launch_bounds__(32 * NWARPS)
ring_flash_hop_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                      int Sk, int D, float scale_log2, Carry carry) {
  flash_tile<NWARPS, BK, false, true>(q, k, v, sq, sk, sv, out, lse, Sk, H, Sq, Sk, D,
                                      scale_log2, 0, blockIdx.x * 16 * NWARPS, blockIdx.y,
                                      blockIdx.z, carry);
}

// One hop's payload and the source slot of the EF stacks (K at [0], V at [1]).
struct CringArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  Strides sq, sk, sv;
  const uint8_t* packed[2];     // (B, H, Sk, D/8 or D/4) per-head grouped codes; null for LOW_RANK
  const __nv_bfloat16* u[2];    // (N, K) scale rows
  const __nv_bfloat16* vcol[2]; // (K, C) scale columns
  int rank;                     // K
  void* base[2];                // slot src: (N, C) fp32, or (N, C) uint8 codes
  __nv_bfloat16* bscale[2];     // slot src (1, C) bf16 int8 scale, or null
  __nv_bfloat16* bmin[2];       // slot src (1, C) bf16 int8 minimum, or null
  __nv_bfloat16* rec[2];        // (B, Sk, H, D) bf16 reconstruction scratch
  __nv_bfloat16* out;
  float* lse;
  Carry carry;
  int B, Sq, Sk, H, D;
  int codec;  // 0 binary, 1 int2, 2 lowrank
  int quantized;
  float scale_log2;
};

// base + delta of element (n, dd) of head h, batch b, for K (w = 0) or V (1):
// the reconstruction, which is also the slot's new EF base.
__device__ __forceinline__ float reconstruct(const CringArgs& a, int w, int b, int h, int n,
                                             int dd) {
  const int C = a.H * a.D;
  const long long row = static_cast<long long>(b) * a.Sk + n;
  const int col = h * a.D + dd;
  const __nv_bfloat16* u = a.u[w] + row * a.rank;
  const __nv_bfloat16* vc = a.vcol[w] + col;
  float s = __fmul_rn(__bfloat162float(u[0]), __bfloat162float(vc[0]));
  for (int i = 1; i < a.rank; ++i) {
    s = __fadd_rn(s, __fmul_rn(__bfloat162float(u[i]), __bfloat162float(vc[static_cast<long long>(i) * C])));
  }
  float delta = s;
  if (a.codec == 0) {
    const int g = a.D / 8;
    const uint8_t byte = a.packed[w][((static_cast<long long>(b) * a.H + h) * a.Sk + n) * g + dd % g];
    delta = ((byte >> (dd / g)) & 1) ? s : -s;
  } else if (a.codec == 1) {
    const int g = a.D / 4;
    const uint8_t byte = a.packed[w][((static_cast<long long>(b) * a.H + h) * a.Sk + n) * g + dd % g];
    const int code = (byte >> (2 * (dd / g))) & 3;
    const float val = (code >= 2 ? 1.f : -1.f) * ((code & 1) ? 2.f : 0.5f);
    delta = __fmul_rn(val, s);
  }
  float base;
  if (a.quantized) {
    const uint8_t c = static_cast<const uint8_t*>(a.base[w])[row * C + col];
    base = __fadd_rn(__fmul_rn(static_cast<float>(c), __bfloat162float(a.bscale[w][col])),
                     __bfloat162float(a.bmin[w][col]));
  } else {
    base = static_cast<const float*>(a.base[w])[row * C + col];
  }
  return __fadd_rn(base, delta);
}

template <int NWARPS, int BK>
__global__ void __launch_bounds__(32 * NWARPS) compact_ring_hop_kernel(CringArgs a) {
  constexpr int NT = 32 * NWARPS;
  constexpr int BQ = 16 * NWARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = a.D, Sk = a.Sk, C = a.H * a.D;
  const bool keep_rec = !a.carry.first;  // hop 0 attends the exact K/V
  // per-channel min and max of the int8 requant, after the flash layout
  float* ch_min = reinterpret_cast<float*>(smem + make_layout(D, BQ, BK).bytes);
  float* ch_max = ch_min + D;

  for (int w = 0; w < 2; ++w) {
    if (!a.quantized) {
      float* base = static_cast<float*>(a.base[w]);
      for (int idx = tid; idx < Sk * D; idx += NT) {
        const int n = idx / D, dd = idx % D;
        const float blk = reconstruct(a, w, b, h, n, dd);
        base[(static_cast<long long>(b) * Sk + n) * C + h * D + dd] = blk;
        if (keep_rec) a.rec[w][((static_cast<long long>(b) * Sk + n) * a.H + h) * D + dd] = __float2bfloat16(blk);
      }
    } else {
      // 1. min and max of the new block over the Sk rows, per channel
      for (int dd = tid; dd < D; dd += NT) {
        float mn = CUDART_INF_F, mx = -CUDART_INF_F;
        for (int n = 0; n < Sk; ++n) {
          const float blk = reconstruct(a, w, b, h, n, dd);
          mn = fminf(mn, blk);
          mx = fmaxf(mx, blk);
        }
        ch_min[dd] = mn;
        ch_max[dd] = mx;
      }
      __syncthreads();
      // 2. codes (each element read, then written, by one thread)
      uint8_t* codes = static_cast<uint8_t*>(a.base[w]);
      for (int idx = tid; idx < Sk * D; idx += NT) {
        const int n = idx / D, dd = idx % D;
        const float blk = reconstruct(a, w, b, h, n, dd);
        const float mn = ch_min[dd];
        const float sc = __fdiv_rn(__fadd_rn(__fsub_rn(ch_max[dd], mn), 1e-6f), 255.f);
        const float code = fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(blk, mn), sc)), 0.f), 255.f);
        codes[(static_cast<long long>(b) * Sk + n) * C + h * D + dd] = static_cast<uint8_t>(code);
        if (keep_rec) a.rec[w][((static_cast<long long>(b) * Sk + n) * a.H + h) * D + dd] = __float2bfloat16(blk);
      }
      __syncthreads();  // every reader of the old scale and min is done
      // 3. the new scale and min of the slot's channels
      for (int dd = tid; dd < D; dd += NT) {
        const float mn = ch_min[dd];
        const float sc = __fdiv_rn(__fadd_rn(__fsub_rn(ch_max[dd], mn), 1e-6f), 255.f);
        a.bscale[w][h * D + dd] = __float2bfloat16(sc);
        a.bmin[w][h * D + dd] = __float2bfloat16(mn);
      }
      __syncthreads();  // ch_min/ch_max are free for V
    }
  }
  __syncthreads();  // the reconstruction is written before any tile reads it

  const __nv_bfloat16* kk = keep_rec ? a.rec[0] : a.k;
  const __nv_bfloat16* vv = keep_rec ? a.rec[1] : a.v;
  const Strides rs{static_cast<long long>(Sk) * a.H * D, static_cast<long long>(a.H) * D, D};
  const Strides sk = keep_rec ? rs : a.sk, sv = keep_rec ? rs : a.sv;
  for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's rows are written out
    flash_tile<NWARPS, BK, false, true>(a.q, kk, vv, a.sq, sk, sv, a.out, a.lse, Sk, a.H, a.Sq,
                                        Sk, D, a.scale_log2, 0, q0, h, b, a.carry);
  }
}

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int NWARPS, int BK>
int launch_ring_hop(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    Strides sq, Strides sk, Strides sv, __nv_bfloat16* out, float* lse, int B,
                    int Sq, int Sk, int H, int D, float scale_log2, Carry carry,
                    cudaStream_t stream) {
  constexpr int BQ = 16 * NWARPS;
  const Layout L = make_layout(D, BQ, BK);
  if (int e = set_smem(ring_flash_hop_kernel<NWARPS, BK>, L.bytes)) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  ring_flash_hop_kernel<NWARPS, BK><<<grid, 32 * NWARPS, L.bytes, stream>>>(
      q, k, v, sq, sk, sv, out, lse, H, Sq, Sk, D, scale_log2, carry);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int NWARPS>
int launch_ring_hop_reg(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        Strides sq, Strides sk, Strides sv, __nv_bfloat16* out, float* lse, int B,
                        int Sq, int Sk, int H, int D, float scale_log2, Carry carry,
                        cudaStream_t stream) {
  constexpr int BQ = 16 * NWARPS, BYTES = RegLayout<DP, NWARPS>::kBytes;
  if (int e = set_smem(ring_flash_hop_reg_kernel<DP, NWARPS>, BYTES)) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  ring_flash_hop_reg_kernel<DP, NWARPS><<<grid, 32 * NWARPS, BYTES, stream>>>(
      q, k, v, sq, sk, sv, out, lse, H, Sq, Sk, D, scale_log2, carry);
  return static_cast<int>(cudaGetLastError());
}

template <int NWARPS, int BK>
int launch_compact_hop(const CringArgs& a, cudaStream_t stream) {
  const int bytes = make_layout(a.D, 16 * NWARPS, BK).bytes + 2 * a.D * 4;
  if (int e = set_smem(compact_ring_hop_kernel<NWARPS, BK>, bytes)) return e;
  dim3 grid(a.H, a.B);
  compact_ring_hop_kernel<NWARPS, BK><<<grid, 32 * NWARPS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One hop of the uncompressed ring: q (B, Sq, H, D) against this hop's
// k/v (B, Sk, H, D), folded into the state m, l (B, H, Sq), acc (B, H, Sq, D),
// with the plan (body, dp, warps) of ops/flash.py::flash_plan: the register
// body at a built (dp, warps) with D <= dp, or the shared-memory body with
// dp = D rounded up to 16 and 4 or 2 warps; anything else is an error.
extern "C" int cf_ring_flash_hop_bf16(const void* q, const void* k, const void* v,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      void* m, void* l, void* acc, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int D, float scale,
                                      int first, int last, int body, int dp, int warps,
                                      void* stream) {
  const cudaError_t refused = cudaErrorInvalidValue;
  if (D % 8 != 0 || D > dp) return static_cast<int>(refused);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Carry carry{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
                    first, last};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  const auto st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  if (body == kRegBody) {
#define CF_REG_CASE(DPV, W)                                                                      \
  if (dp == DPV && warps == W) {                                                                  \
    return launch_ring_hop_reg<DPV, W>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, Sk, H, D, sl2, carry, \
                                       st);                                                       \
  }
    CF_REG_PLANS(CF_REG_CASE)
#undef CF_REG_CASE
    return static_cast<int>(refused);
  }
  if (body != kTileBody || dp != round_up(D, 16)) return static_cast<int>(refused);
  if (warps == 4) {
    return launch_ring_hop<4, 64>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, Sk, H, D, sl2, carry, st);
  }
  if (warps == 2) {
    return launch_ring_hop<2, 32>(qp, kp, vp, sq, sk, sv, op, lp, B, Sq, Sk, H, D, sl2, carry, st);
  }
  return static_cast<int>(refused);
}

// One hop of the compressed ring.  pk/pv: per-head packed codes (null for
// LOW_RANK); uk/uv (N, K), vk/vv (K, C) bf16 scales; kb/vb the source slot
// of the EF stacks, (N, C) fp32, or uint8 codes with ks/km, vs/vm its
// (1, C) bf16 scale and min when quantized; rec_k/rec_v (B, Sk, H, D) bf16
// scratch; codec 0 binary, 1 int2, 2 lowrank.
extern "C" int cf_compact_ring_hop(const void* q, const void* k, const void* v,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   const void* pk, const void* pv, const void* uk,
                                   const void* uv, const void* vk, const void* vv, int rank,
                                   void* kb, void* ks, void* km, void* vb, void* vs, void* vm,
                                   void* rec_k, void* rec_v, void* m, void* l, void* acc,
                                   void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                                   int codec, int quantized, int first, int last, float scale,
                                   void* stream) {
  if (B == 0 || H == 0) return 0;
  if (codec < 0 || codec > 2 || rank < 1 || (codec != 2 && (pk == nullptr || pv == nullptr)) ||
      (quantized && (ks == nullptr || km == nullptr || vs == nullptr || vm == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CringArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.sq = Strides{qsb, qss, qsh};
  a.sk = Strides{ksb, kss, ksh};
  a.sv = Strides{vsb, vss, vsh};
  a.packed[0] = static_cast<const uint8_t*>(pk);
  a.packed[1] = static_cast<const uint8_t*>(pv);
  a.u[0] = static_cast<const __nv_bfloat16*>(uk);
  a.u[1] = static_cast<const __nv_bfloat16*>(uv);
  a.vcol[0] = static_cast<const __nv_bfloat16*>(vk);
  a.vcol[1] = static_cast<const __nv_bfloat16*>(vv);
  a.rank = rank;
  a.base[0] = kb;
  a.base[1] = vb;
  a.bscale[0] = static_cast<__nv_bfloat16*>(ks);
  a.bscale[1] = static_cast<__nv_bfloat16*>(vs);
  a.bmin[0] = static_cast<__nv_bfloat16*>(km);
  a.bmin[1] = static_cast<__nv_bfloat16*>(vm);
  a.rec[0] = static_cast<__nv_bfloat16*>(rec_k);
  a.rec[1] = static_cast<__nv_bfloat16*>(rec_v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.carry = Carry{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
                  first, last};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.D = D;
  a.codec = codec;
  a.quantized = quantized;
  a.scale_log2 = scale * kLog2e;
  const auto st = static_cast<cudaStream_t>(stream);
  // 8 warps (128-row q-tiles) while the layout fits, as only B*H CTAs run
  if (make_layout(D, 128, 64).bytes + 8 * D <= 200 * 1024) return launch_compact_hop<8, 64>(a, st);
  if (make_layout(D, 64, 64).bytes + 8 * D <= 200 * 1024) return launch_compact_hop<4, 64>(a, st);
  if (make_layout(D, 32, 32).bytes + 8 * D <= 227 * 1024) return launch_compact_hop<2, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
