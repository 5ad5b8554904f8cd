"""Fused ring attention, plain and compressed: the CUDA kernels' wrappers and
their plain twins (counterpart of ``compactfusion_tpu/ops/ring_flash_pallas.py``).

The TPU kernels rotate K/V (kernel 7) or the packed compressed payload
(kernel 8) around the ring by in-kernel RDMA inside one launch.  Here the
transport is ``parallel/ring.ring_shift`` between launches, and each kernel
folds one hop into a running fp32 online-softmax state (m, l, acc) held in
device memory: one launch per hop, the last one writing out and LSE.  The
wrappers take the hops as an iterable (``parallel/ring.ring_blocks``), so
the exchange for hop s + 1 runs while hop s computes.  The kernels are in
``csrc/ring_flash.cu``.  On CUDA tensors a wrapper launches its kernel or
raises; on CPU tensors it runs its twin: per hop, attention with LSE (and,
for kernel 8, the dequant and EF slot update), then ``merge_out_lse``.

Fused payload (kernel 8), per call: packed codes grouped within each head
(bit i of byte j is channel i*(D/8)+j of the head, crumb i of byte j
channel i*(D/4)+j), (B, H, Sk, D/8) or (B, H, Sk, D/4) uint8, for K and V;
the scale rows u (N, K) and columns v (K, C) in bf16, N = B*Sk, C = H*D.
LOW_RANK sends no codes: (u, v) is the reconstruction of the delta.  The
u rows are head-invariant and travel once per call, so the wire bytes equal
the unfused payload's.  Both ends of a ring take this route or neither.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Tuple

import torch

from compactfusion_tpu_torch.compact import codecs
from compactfusion_tpu_torch.compact.codecs import Int8Payload
from compactfusion_tpu_torch.ops.merge import merge_out_lse

FUSED_CODECS = ("binary", "int2", "lowrank")
_CODEC_ID = {"binary": 0, "int2": 1, "lowrank": 2}


def _attn_partial(q, k, v, scale):
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, None, None)


# -- kernel 7: the uncompressed ring --------------------------------------------


def ring_flash_attn_with_lse_ref(q, kv_blocks: Iterable, ring_size: int,
                                 scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: per hop attention with LSE against the hop's (k, v),
    merged in fp32."""
    out = lse = None
    hops = 0
    for k, v in kv_blocks:
        out, lse = merge_out_lse(out, lse, *_attn_partial(q, k, v, scale))
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out.to(q.dtype), lse


def ring_flash_attn_with_lse(q: torch.Tensor, kv_blocks: Iterable, ring_size: int,
                             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention of the local queries q (B, Sq, H, D) over the
    ring's K/V blocks -> (out (B, Sq, H, D) q.dtype, lse (B, H, Sq) fp32).
    ``kv_blocks`` yields ``ring_size`` pairs (k, v), each (B, Sk, H, D),
    the local shard first.  A row with no key gives 0 and LSE -inf.

    On CUDA tensors: one launch per hop with ``ops.flash.flash_plan``'s
    plan; q and the state are checked once per call, each hop's k/v as it
    comes."""
    if not q.is_cuda:
        return ring_flash_attn_with_lse_ref(q, kv_blocks, ring_size, scale)

    from compactfusion_tpu_torch.ops import _build
    from compactfusion_tpu_torch.ops.flash import _check_kv, _check_q, flash_plan, plan_args

    _check_q(q)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    plan = plan_args(flash_plan(b, h, sq, d))
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty_like(m)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fixed = (q.data_ptr(), *q.stride()[:3])
    state = (m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), lse.data_ptr())
    c_scale = ctypes.c_float(scale)
    hops = 0
    for k, v in kv_blocks:
        if hops >= ring_size:
            raise ValueError(f"ring of {ring_size} got more hops")
        _check_kv(q, k, v)
        status = lib.cf_ring_flash_hop_bf16(
            fixed[0], k.data_ptr(), v.data_ptr(), *fixed[1:], *k.stride()[:3], *v.stride()[:3],
            *state, b, sq, k.shape[1], h, d, c_scale,
            int(hops == 0), int(hops == ring_size - 1), *plan, stream,
        )
        _build.check(status, "ring_flash_attn_with_lse")
        ring_flash_attn_with_lse.launches += 1
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out, lse


#: kernel launches (one per hop) since the count was last set to 0
ring_flash_attn_with_lse.launches = 0


# -- kernel 8: the compressed ring ----------------------------------------------


def pack_bits_per_head(bits: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) {0,1} -> (B, H, S, D/8) uint8, grouped within the head:
    bit i of byte j is channel i*(D/8)+j."""
    b, h, s, d = bits.shape
    r = bits.to(torch.uint8).reshape(b, h, s, 8, d // 8)
    out = r[..., 0, :].clone()
    for i in range(1, 8):
        out |= r[..., i, :] << i
    return out


def pack_2bit_per_head(codes: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) codes in [0, 3] -> (B, H, S, D/4) uint8, grouped within
    the head: crumb i of byte j is channel i*(D/4)+j."""
    b, h, s, d = codes.shape
    r = codes.to(torch.uint8).reshape(b, h, s, 4, d // 4)
    out = r[..., 0, :].clone()
    for i in range(1, 4):
        out |= r[..., i, :] << (2 * i)
    return out


def _unpack_per_head(packed: torch.Tensor, bits: int) -> torch.Tensor:
    mask = (1 << bits) - 1
    return torch.cat([(packed >> (bits * i)) & mask for i in range(8 // bits)], dim=-1)


def _to_bhsd(x_nc: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    return x_nc.reshape(b, s, h, d).permute(0, 2, 1, 3)


def _to_nc(x_bhsd: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x_bhsd.shape
    return x_bhsd.permute(0, 2, 1, 3).reshape(b * s, h * d)


def fused_ring_payload(k: torch.Tensor, v: torch.Tensor, k_base_my: torch.Tensor,
                       v_base_my: torch.Tensor, codec: str, comp_rank: int,
                       awl_k: Optional[torch.Tensor] = None) -> tuple:
    """Sender side of the fused compressed ring (outside the kernel, as in
    JAX): the deltas of this rank's K/V (B, Sk, H, D) against its own EF
    slot (N, C) fp32, their scale models and codes -> the payload tuple
    ``(pk, pv, uk, uv, vk, vv)`` (LOW_RANK: ``(uk, uv, vk, vv)``).

    BINARY: signs and the rank-``comp_rank`` scale of |delta| (mean scale
    at -1); INT2: sign+magnitude codes, thresholded on the fp32 mean scale;
    LOW_RANK: the signed rank-``comp_rank`` factors of the delta, the K fit
    weighted by ``awl_k`` (N,) for LOW_RANK_AWL.  Scales are rounded to
    bf16, as they travel."""
    if codec not in FUSED_CODECS:
        raise ValueError(f"fused ring codec must be one of {FUSED_CODECS}, got {codec!r}")
    b, sk, h, d = k.shape
    dk = k.reshape(b * sk, h * d).float() - k_base_my.float()
    dv = v.reshape(b * sk, h * d).float() - v_base_my.float()
    if codec == "int2":
        uk, vk = codecs._mean_scale_uv(dk)
        uv, vv = codecs._mean_scale_uv(dv)
    elif codec == "lowrank":
        if comp_rank < 1:
            raise ValueError("the fused LOW_RANK ring needs comp_rank >= 1")
        if awl_k is not None:
            s_row = awl_k.float()[:, None]
            u_w, vk, _ = codecs.subspace_iter(dk * s_row, comp_rank, num_iters=2)
            uk = u_w / s_row
        else:
            uk, vk, _ = codecs.subspace_iter(dk, comp_rank, num_iters=2)
        uv, vv, _ = codecs.subspace_iter(dv, comp_rank, num_iters=2)
    else:
        uk, vk = codecs._scale_uv(dk, comp_rank)
        uv, vv = codecs._scale_uv(dv, comp_rank)
    wire = tuple(codecs._wire(t) for t in (uk, uv, vk, vv))
    if codec == "lowrank":
        return wire
    if codec == "int2":
        # codes threshold on the fp32 scale; the receiver rebuilds with the
        # bf16 wire scale (codecs.encode_int2 / decode_int2)
        pk = pack_2bit_per_head(_to_bhsd(codecs._int2_codes(dk, uk * vk), b, sk, h, d))
        pv = pack_2bit_per_head(_to_bhsd(codecs._int2_codes(dv, uv * vv), b, sk, h, d))
    else:
        pk = pack_bits_per_head(_to_bhsd(dk >= 0, b, sk, h, d))
        pv = pack_bits_per_head(_to_bhsd(dv >= 0, b, sk, h, d))
    return (pk.contiguous(), pv.contiguous()) + wire


def _split_payload(codec: str, payload) -> tuple:
    """(pk, pv, uk, uv, vk, vv), the codes None for LOW_RANK."""
    if codec == "lowrank":
        return (None, None) + tuple(payload)
    return tuple(payload)


def _scale_sum(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u (N, K) @ v (K, C) in fp32, summed over k in order: every term is an
    exact product of bf16 values, so the kernel's sum in the same order
    equals this bit for bit, FMA or not."""
    u32, v32 = u.float(), v.float()
    s = u32[:, 0:1] * v32[0:1]
    for i in range(1, u32.shape[1]):
        s = s + u32[:, i:i + 1] * v32[i:i + 1]
    return s


def decode_slot(base, src: int) -> torch.Tensor:
    """Slot ``src`` of an EF stack (fp32, or an int8 ``Int8Payload`` stack)
    in fp32."""
    if isinstance(base, Int8Payload):
        return codecs.decode_int8(Int8Payload(base.q[src], base.scale[src], base.minv[src]))
    return base[src].float()


def _requant(x32: torch.Tensor) -> Int8Payload:
    """``codecs.encode_int8`` with the scale's division by 255 taken as a
    true division on every device (a division of a CUDA tensor by a Python
    number multiplies by its reciprocal), as the kernel takes it."""
    mn, mx = torch.aminmax(x32, dim=0, keepdim=True)
    sc = (mx - mn + codecs._EPS) / torch.full_like(mn, 255.0)
    codes = torch.round((x32 - mn) / sc).clamp(0, 255).to(torch.uint8)
    return Int8Payload(codes, codecs._wire(sc), codecs._wire(mn))


def _update_slot_ref(base, src: int, codec: str, packed, u, v, shape) -> torch.Tensor:
    """Reconstruct slot ``src`` from a fused payload, write it back as the
    slot's new EF base IN PLACE, and return the reconstruction (N, C) fp32."""
    b, sk, h, d = shape
    s = _scale_sum(u, v)
    if codec == "lowrank":
        delta = s
    else:
        codes = _to_nc(_unpack_per_head(packed, 1 if codec == "binary" else 2))
        if codec == "binary":
            val = codes.float() * 2.0 - 1.0
        else:
            val = torch.where(codes >= 2, 1.0, -1.0) * torch.where((codes & 1).bool(), 2.0, 0.5)
        delta = val * s
    blk = decode_slot(base, src) + delta
    if isinstance(base, Int8Payload):
        new = _requant(blk)
        for a, n in zip(base, new):
            a[src].copy_(n)
    else:
        base[src].copy_(blk)
    return blk


def compact_ring_flash_ref(q, k, v, k_base, v_base, payloads: Iterable, *, codec: str, my: int,
                           ring_size: int, scale: Optional[float] = None):
    """Plain twin of :func:`compact_ring_flash`: per hop, the dequant and EF
    update of slot (my - s) % R, attention with LSE against the local exact
    K/V at hop 0 and the reconstruction (rounded to k.dtype) after, merged
    in fp32."""
    shape = tuple(k.shape)
    out = lse = None
    hops = 0
    for step, payload in enumerate(payloads):
        src = (my - step) % ring_size
        pk, pv, uk, uv, vk, vv = _split_payload(codec, payload)
        k_rec = _update_slot_ref(k_base, src, codec, pk, uk, vk, shape)
        v_rec = _update_slot_ref(v_base, src, codec, pv, uv, vv, shape)
        if step == 0:
            kk, vv_ = k, v
        else:
            kk, vv_ = k_rec.reshape(shape).to(k.dtype), v_rec.reshape(shape).to(v.dtype)
        out, lse = merge_out_lse(out, lse, *_attn_partial(q, kk, vv_, scale))
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out.to(q.dtype), lse


def _check_base(name, base, r, n, c, quantized):
    parts = base if quantized else (base,)
    want = ((r, n, c), (r, 1, c), (r, 1, c)) if quantized else ((r, n, c),)
    dts = (torch.uint8, torch.bfloat16, torch.bfloat16) if quantized else (torch.float32,)
    for t, shp, dt in zip(parts, want, dts):
        if tuple(t.shape) != shp or t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"compact ring kernel: {name} base must be contiguous CUDA {shp} {dt}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def compact_ring_flash(q, k, v, k_base, v_base, payloads: Iterable, *, codec: str, my: int,
                       ring_size: int, scale: Optional[float] = None):
    """The compressed ring, one kernel launch per hop: dequant of the hop's
    payload, EF update of slot src = (my - s) % R in place, attention of q
    against the local exact K/V (hop 0) or the bf16 reconstruction, folded
    into the running softmax state.

    q/k/v (B, S, H, D) bf16; ``k_base``/``v_base`` this layer's EF stacks,
    (R, N, C) fp32 tensors or ``Int8Payload`` stacks (codes (R, N, C),
    scale and min (R, 1, C) bf16; B == 1 only: the per-channel min-max of
    the requant runs over one (b, h) block's Sk rows); ``payloads`` yields
    ``ring_size`` payload tuples of :func:`fused_ring_payload`, the own
    first.  Returns (out (B, S, H, D), lse (B, H, S) fp32)."""
    if codec not in FUSED_CODECS:
        raise ValueError(f"fused ring codec must be one of {FUSED_CODECS}, got {codec!r}")
    quantized = isinstance(k_base, Int8Payload)
    if quantized and k.shape[0] != 1:
        raise ValueError(f"int8 EF bases take the fused ring at B == 1, got B={k.shape[0]}")
    if not q.is_cuda:
        return compact_ring_flash_ref(q, k, v, k_base, v_base, payloads, codec=codec, my=my,
                                      ring_size=ring_size, scale=scale)

    from compactfusion_tpu_torch.ops import _build
    from compactfusion_tpu_torch.ops.flash import _check_qkv

    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n, c = b * sk, h * d
    _check_base("k", k_base, ring_size, n, c, quantized)
    _check_base("v", v_base, ring_size, n, c, quantized)
    if scale is None:
        scale = d**-0.5
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty_like(m)
    rec_k = torch.empty((b, sk, h, d), dtype=torch.bfloat16, device=q.device)
    rec_v = torch.empty_like(rec_k)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def slot(base, src):
        """(codes or fp32 base, scale, min) pointers of slot src."""
        if quantized:
            return base.q[src].data_ptr(), base.scale[src].data_ptr(), base.minv[src].data_ptr()
        return base[src].data_ptr(), None, None

    hops = 0
    for payload in payloads:
        if hops >= ring_size:
            raise ValueError(f"ring of {ring_size} got more hops")
        pk, pv, uk, uv, vk, vv = _split_payload(codec, payload)
        rank = uk.shape[1]
        for t, shp, dt in ((uk, (n, rank), torch.bfloat16), (uv, (n, rank), torch.bfloat16),
                           (vk, (rank, c), torch.bfloat16), (vv, (rank, c), torch.bfloat16)):
            if tuple(t.shape) != shp or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"compact ring kernel: scale factor {tuple(t.shape)} {t.dtype}, "
                                 f"want contiguous {shp} {dt}")
        if codec != "lowrank":
            width = d // 8 if codec == "binary" else d // 4
            for t in (pk, pv):
                if tuple(t.shape) != (b, h, sk, width) or t.dtype != torch.uint8 or not t.is_contiguous():
                    raise ValueError(f"compact ring kernel: packed codes {tuple(t.shape)} {t.dtype}, "
                                     f"want contiguous {(b, h, sk, width)} uint8")
        src = (my - hops) % ring_size
        kq, ks, km = slot(k_base, src)
        vq, vs, vm = slot(v_base, src)
        status = lib.cf_compact_ring_hop(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            None if pk is None else pk.data_ptr(), None if pv is None else pv.data_ptr(),
            uk.data_ptr(), uv.data_ptr(), vk.data_ptr(), vv.data_ptr(), rank,
            kq, ks, km, vq, vs, vm,
            rec_k.data_ptr(), rec_v.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, sk, h, d, _CODEC_ID[codec], int(quantized),
            int(hops == 0), int(hops == ring_size - 1), ctypes.c_float(scale), stream,
        )
        _build.check(status, "compact_ring_flash")
        compact_ring_flash.launches += 1
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out, lse


#: kernel launches (one per hop) since the count was last set to 0
compact_ring_flash.launches = 0
