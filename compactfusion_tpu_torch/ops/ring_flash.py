"""Fused ring attention, plain and compressed: the CUDA kernels' wrappers and
their plain twins (counterpart of ``compactfusion_tpu/ops/ring_flash_pallas.py``).

The TPU kernels rotate K/V (kernel 7) or the packed compressed payload
(kernel 8) around the ring by in-kernel RDMA inside one launch.  Here the
transport is ``parallel/ring.ring_shift`` between launches, and each kernel
folds one hop into a running fp32 online-softmax state (m, l, acc) held in
device memory: one flash launch per hop, the last one writing out and LSE.
Kernel 8 runs, per hop and in stream order, the EF pass
(:func:`ef_update_slot`: dequant of the hop's payload and the EF update of
its source slot in place, with a copy of the reconstruction in the
activation dtype: rounded to bf16, or not rounded in fp32) and then kernel
7's launch on that copy.  Both take bf16 or fp32 q/k/v (fp32 on the
register body in 3xTF32, ``csrc/flash_reg.cuh``).  The wrappers take the
hops as an iterable (``parallel/ring.ring_blocks``), so the exchange for
hop s + 1 runs while hop s computes.  The kernels are in
``csrc/ring_flash.cu``.  On CUDA
tensors a wrapper launches its kernels or raises; on CPU tensors it runs
its twin: per hop, attention with LSE (and, for kernel 8, the dequant and
EF slot update), then ``merge_out_lse``.

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
from compactfusion_tpu_torch.utils.prof import count

FUSED_CODECS = ("binary", "int2", "lowrank")
_CODEC_ID = {"binary": 0, "int2": 1, "lowrank": 2}
#: rows of one CTA tile of the EF pass (``kEfRows`` in ``csrc/ring_flash.cu``):
#: on int8 stacks the scratch holds a min and a max per channel and tile
EF_ROWS = 64


def _attn_partial(q, k, v, scale):
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, None, None)


def _hop(lib, plan, q, q_map, k, v, state, scale, first, last, f32, stream) -> Tuple[int, tuple]:
    """One launch of kernel 7's hop of q against k/v at ``plan`` (the wgmma
    body's through ``q_map``, q's tensor map encoded once a call; a hop with
    no key takes the register body: a tensor map cannot describe an empty
    tensor), folded into ``state`` (m, l, acc, out, lse pointers); returns
    the C status and the plan it ran."""
    from compactfusion_tpu_torch.ops.flash import WG_BK, launch_plan, plan_args, tma_map

    b, sq, h, d = q.shape
    sk = k.shape[1]
    if plan[0] == "flash_wgmma_tile" and sk:
        _, dp, warps = plan
        return lib.cf_ring_flash_hop_wgmma(
            *q_map, *tma_map(lib, "k", k, dp, WG_BK), *tma_map(lib, "v", v, dp, WG_BK), *state,
            b, sq, sk, h, d, scale, int(first), int(last), dp, warps, stream,
        ), plan
    if plan[0] == "flash_wgmma_tile":
        plan, _ = launch_plan(b, h, sq, d, q.dtype)
    return lib.cf_ring_flash_hop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *state, b, sq, sk, h, d, scale, int(first), int(last), *plan_args(plan), int(f32), stream,
    ), plan


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
    plan for kernel 7; q and the state are checked once per call (on the
    wgmma body q's tensor map is encoded once), each hop's k/v as it
    comes."""
    if not q.is_cuda:
        return ring_flash_attn_with_lse_ref(q, kv_blocks, ring_size, scale)

    from compactfusion_tpu_torch.ops import _build
    from compactfusion_tpu_torch.ops.flash import _check_kv, _check_q, launch_plan, launched, plan_rows, tma_map

    _check_q(q)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    plan, f32 = launch_plan(b, h, sq, d, q.dtype, kernel=7)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty_like(m)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_map = tma_map(lib, "q", q, plan[1], plan_rows(plan)) if plan[0] == "flash_wgmma_tile" else None
    state = (m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), lse.data_ptr())
    c_scale = ctypes.c_float(scale)
    hops = 0
    for k, v in kv_blocks:
        if hops >= ring_size:
            raise ValueError(f"ring of {ring_size} got more hops")
        _check_kv(q, k, v)
        status, ran = _hop(lib, plan, q, q_map, k, v, state, c_scale, hops == 0, hops == ring_size - 1, f32, stream)
        _build.check(status, "ring_flash_attn_with_lse")
        # the Profiler's counters: launches (one per hop), those on the wgmma
        # body, and those on fp32 q/k/v
        count("ring_flash_attn_with_lse.launches")
        count("ring_flash_attn_with_lse.wgmma_launches", ran[0] == "flash_wgmma_tile")
        count("ring_flash_attn_with_lse.f32_launches", f32)
        launched(ran)
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out, lse


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


def payload_delta(codec: str, packed, u, v) -> torch.Tensor:
    """The delta (N, C) fp32 one K or V part of a fused payload carries."""
    s = _scale_sum(u, v)
    if codec == "lowrank":
        return s
    codes = _to_nc(_unpack_per_head(packed, 1 if codec == "binary" else 2))
    if codec == "binary":
        val = codes.float() * 2.0 - 1.0
    else:
        val = torch.where(codes >= 2, 1.0, -1.0) * torch.where((codes & 1).bool(), 2.0, 0.5)
    return val * s


def _update_slot_ref(base, src: int, codec: str, packed, u, v) -> torch.Tensor:
    """Reconstruct slot ``src`` from a fused payload, write it back as the
    slot's new EF base IN PLACE, and return the reconstruction (N, C) fp32."""
    blk = decode_slot(base, src) + payload_delta(codec, packed, u, v)
    if isinstance(base, Int8Payload):
        new = _requant(blk)
        for a, n in zip(base, new):
            a[src].copy_(n)
    else:
        base[src].copy_(blk)
    return blk


def ef_update_slot_ref(k_base, v_base, src: int, codec: str, payload) -> tuple:
    """Plain twin of :func:`ef_update_slot`: the reconstructions (N, C) fp32
    of K and V from a fused payload, written back IN PLACE as slot ``src``'s
    new EF bases (int8 stacks requantized)."""
    pk, pv, uk, uv, vk, vv = _split_payload(codec, payload)
    return (_update_slot_ref(k_base, src, codec, pk, uk, vk),
            _update_slot_ref(v_base, src, codec, pv, uv, vv))


def compact_ring_flash_ref(q, k, v, k_base, v_base, payloads: Iterable, *, codec: str, my: int,
                           ring_size: int, scale: Optional[float] = None):
    """Plain twin of :func:`compact_ring_flash`: per hop, the dequant and EF
    update of slot (my - s) % R, attention with LSE against the local exact
    K/V at hop 0 and the reconstruction (rounded to k.dtype: bf16, or not
    rounded in fp32) after, merged in fp32."""
    shape = tuple(k.shape)
    out = lse = None
    hops = 0
    for step, payload in enumerate(payloads):
        k_rec, v_rec = ef_update_slot_ref(k_base, v_base, (my - step) % ring_size, codec, payload)
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


def _check_payload(codec, payload, b, sk, h, d):
    """The hop's payload as the EF pass takes it; returns its six parts."""
    pk, pv, uk, uv, vk, vv = _split_payload(codec, payload)
    n, c, rank = b * sk, h * d, uk.shape[1]
    for t, shp in ((uk, (n, rank)), (uv, (n, rank)), (vk, (rank, c)), (vv, (rank, c))):
        if tuple(t.shape) != shp or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"EF pass: scale factor {tuple(t.shape)} {t.dtype}, "
                             f"want contiguous {shp} torch.bfloat16")
    if codec != "lowrank":
        width = d // 8 if codec == "binary" else d // 4
        for t in (pk, pv):
            if tuple(t.shape) != (b, h, sk, width) or t.dtype != torch.uint8 or not t.is_contiguous():
                raise ValueError(f"EF pass: packed codes {tuple(t.shape)} {t.dtype}, "
                                 f"want contiguous {(b, h, sk, width)} uint8")
    return pk, pv, uk, uv, vk, vv


def ef_update_slot(k_base, v_base, src: int, codec: str, payload, shape, rec=None) -> None:
    """The EF pass of kernel 8 for one hop: slot ``src`` of both EF stacks
    rebuilt from the hop's fused payload (base + delta) and written back IN
    PLACE as the slot's new base (int8 stacks requantized), and, given
    ``rec`` = (rec_k, rec_v) (B, Sk, H, D), the reconstruction there in
    ``rec``'s dtype, the activations' (bf16: rounded; fp32: as it is).
    ``shape`` is (B, Sk, H, D) of the K/V the stacks hold (int8 stacks at
    B == 1 only).

    On CUDA stacks: one launch on fp32 stacks, two on int8 stacks (the
    per-channel min and max, then the codes), each counted under
    ``ef_update_slot.launches`` (and, with an fp32 ``rec``, in
    ``ef_update_slot.f32_launches``).  On CPU stacks the twin runs."""
    dtype = torch.bfloat16 if rec is None else rec[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"EF pass: reconstructions in bfloat16 or float32, got {dtype}")
    if codec not in FUSED_CODECS:
        raise ValueError(f"fused ring codec must be one of {FUSED_CODECS}, got {codec!r}")
    quantized = isinstance(k_base, Int8Payload)
    b, sk, h, d = shape
    if quantized and b != 1:
        raise ValueError(f"int8 EF bases take the fused ring at B == 1, got B={b}")
    lead = k_base.q if quantized else k_base
    if not lead.is_cuda:
        recs = ef_update_slot_ref(k_base, v_base, src, codec, payload)
        for t, x in zip(rec or (), recs):
            t.copy_(x.reshape(t.shape))
        return

    from compactfusion_tpu_torch.ops import _build

    n, c, ring_size = b * sk, h * d, lead.shape[0]
    _check_base("k", k_base, ring_size, n, c, quantized)
    _check_base("v", v_base, ring_size, n, c, quantized)
    if not 0 <= src < ring_size:
        raise ValueError(f"EF pass: slot {src} of a stack of {ring_size}")
    parts = _check_payload(codec, payload, b, sk, h, d)
    if rec is not None:
        for t in rec:
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_contiguous() \
                    or t.device != lead.device:
                raise ValueError(f"EF pass: reconstruction {tuple(t.shape)} {t.dtype}, want "
                                 f"contiguous {tuple(shape)} {dtype} on {lead.device}")
    _ef_launch(_build.load(), k_base, v_base, src, codec, parts, shape, rec,
               _ef_scratch(quantized, n, c, lead.device), torch.cuda.current_stream(lead.device).cuda_stream,
               dtype)


def _ef_scratch(quantized: bool, n: int, c: int, device) -> tuple:
    """(tile min/max (2, T, 2, C) fp32, old scale/min (2, 2, C) bf16, T) of
    the EF pass on int8 stacks of N rows, T its row tiles; (None, None, T)
    on fp32 stacks.  A ring reuses it hop to hop, in stream order."""
    tiles = -(-n // EF_ROWS)
    if not quantized:
        return None, None, tiles
    return (torch.empty((2, tiles, 2, c), dtype=torch.float32, device=device),
            torch.empty((2, 2, c), dtype=torch.bfloat16, device=device), tiles)


def _ef_launch(lib, k_base, v_base, src, codec, parts, shape, rec, scratch, stream, dtype) -> None:
    """The EF pass's launch on checked inputs: ``parts`` the payload's six
    parts (:func:`_check_payload`), ``scratch`` of :func:`_ef_scratch`,
    ``dtype`` the activations' (the reconstruction's)."""
    from compactfusion_tpu_torch.ops import _build

    quantized = isinstance(k_base, Int8Payload)
    pk, pv, uk, uv, vk, vv = parts
    part, snap, tiles = scratch
    b, sk, h, d = shape

    def slot(base):
        """(codes or fp32 base, scale, min) pointers of slot src."""
        if quantized:
            return base.q[src].data_ptr(), base.scale[src].data_ptr(), base.minv[src].data_ptr()
        return base[src].data_ptr(), None, None

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = lib.cf_ef_update_slot(
        ptr(pk), ptr(pv), uk.data_ptr(), uv.data_ptr(), vk.data_ptr(), vv.data_ptr(), uk.shape[1],
        *slot(k_base), *slot(v_base), *(ptr(t) for t in (rec or (None, None))),
        ptr(part), ptr(snap), tiles, b, sk, h, d, _CODEC_ID[codec], int(quantized),
        int(dtype == torch.float32), stream,
    )
    _build.check(status, "ef_update_slot")
    # the Profiler's counters: launches (one per hop on fp32 stacks, two on
    # int8), and those of them for fp32 activations
    count("ef_update_slot.launches", 2 if quantized else 1)
    count("ef_update_slot.f32_launches", (2 if quantized else 1) * (dtype == torch.float32))


def compact_ring_flash(q, k, v, k_base, v_base, payloads: Iterable, *, codec: str, my: int,
                       ring_size: int, scale: Optional[float] = None):
    """The compressed ring, per hop in stream order: the EF pass
    (:func:`ef_update_slot`: dequant of the hop's payload, EF update of slot
    src = (my - s) % R in place, its reconstruction in q's dtype into a
    scratch reused hop to hop), then kernel 7's launch
    (``ops.flash.flash_plan``'s plan) of q against the local exact K/V (hop
    0) or the reconstruction, folded into the running softmax state.

    q/k/v (B, S, H, D) bf16 or fp32; ``k_base``/``v_base`` this layer's EF stacks,
    (R, N, C) fp32 tensors or ``Int8Payload`` stacks (codes (R, N, C),
    scale and min (R, 1, C) bf16; B == 1 only: the per-channel min-max of
    the requant runs over the slot's N = Sk rows); ``payloads`` yields
    ``ring_size`` payload tuples of :func:`fused_ring_payload`, the own
    first.  Returns (out (B, S, H, D), lse (B, H, S) fp32).
    The counter ``compact_ring_flash.launches`` counts the flash launches (one per hop;
    ``wgmma_launches`` those on the wgmma body),
    ``ef_update_slot.launches`` the EF pass's."""
    if codec not in FUSED_CODECS:
        raise ValueError(f"fused ring codec must be one of {FUSED_CODECS}, got {codec!r}")
    quantized = isinstance(k_base, Int8Payload)
    if quantized and k.shape[0] != 1:
        raise ValueError(f"int8 EF bases take the fused ring at B == 1, got B={k.shape[0]}")
    if not q.is_cuda:
        return compact_ring_flash_ref(q, k, v, k_base, v_base, payloads, codec=codec, my=my,
                                      ring_size=ring_size, scale=scale)

    from compactfusion_tpu_torch.ops import _build
    from compactfusion_tpu_torch.ops.flash import _check_qkv, launch_plan, launched, plan_rows, tma_map

    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n, c = b * sk, h * d
    _check_base("k", k_base, ring_size, n, c, quantized)
    _check_base("v", v_base, ring_size, n, c, quantized)
    if scale is None:
        scale = d**-0.5
    plan, f32 = launch_plan(b, h, sq, d, q.dtype, kernel=7)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty_like(m)
    rec = (torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device),
           torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device))
    scratch = _ef_scratch(quantized, n, c, q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_map = tma_map(lib, "q", q, plan[1], plan_rows(plan)) if plan[0] == "flash_wgmma_tile" else None
    state = (m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), lse.data_ptr())
    c_scale = ctypes.c_float(scale)
    hops = 0
    for payload in payloads:
        if hops >= ring_size:
            raise ValueError(f"ring of {ring_size} got more hops")
        _ef_launch(lib, k_base, v_base, (my - hops) % ring_size, codec,
                   _check_payload(codec, payload, b, sk, h, d), (b, sk, h, d), rec if hops else None,
                   scratch, stream, q.dtype)
        kk, vv = rec if hops else (k, v)
        status, ran = _hop(lib, plan, q, q_map, kk, vv, state, c_scale, hops == 0, hops == ring_size - 1, f32,
                           stream)
        _build.check(status, "compact_ring_flash")
        # the Profiler's counters: flash launches (one per hop), those on the
        # wgmma body, and those on fp32 q/k/v; the EF pass counts its own in
        # ``ef_update_slot.launches``
        count("compact_ring_flash.launches")
        count("compact_ring_flash.wgmma_launches", ran[0] == "flash_wgmma_tile")
        count("compact_ring_flash.f32_launches", f32)
        launched(ran)
        hops += 1
    if hops != ring_size:
        raise ValueError(f"ring of {ring_size} got {hops} hops")
    return out, lse
