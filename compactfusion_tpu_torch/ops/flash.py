"""Flash attention with LSE: the CUDA kernels' wrappers and their plain twins.

Counterpart of ``compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse``:
the main branch (:func:`flash_attn_with_lse`) and the ``window=`` branch
(:func:`flash_attn_window_with_lse`, banded attention for DiTFastAttn).  The
kernels are in ``csrc/flash_attn.cu``.  On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor it runs its twin.  The kernels take
bf16 or fp32 q/k/v, as the Pallas kernels take the input dtype: fp32 runs
every body in 3xTF32 (``csrc/flash_reg.cuh``).  Head dims up to 128 take
the wgmma body (``csrc/flash_wgmma.cuh``: kernels 1, 7 and 8's flash
partial on bf16) or the register body (kernel 4 and every fp32 launch),
wider ones (up to :data:`WIDE_MAX_D`) the wide body, which splits the head
dim over warps and, above d = 512, over the CTAs of a cluster
(``csrc/flash_wide.cuh``).

Which body, padded head dim and tile height a launch takes is decided here,
before the launch, by :func:`flash_plan` (so the CPU tests see it), and the C
entry points launch exactly that or return an error.  The TPU tuning flags
of the Pallas wrapper (``fuse_sum``, ``heads_per``, ``bhsd_io``,
``score_bf16``, ``fold_scale``, ``exp_bf16``, ``block_q``/``block_k``) are
not part of this API.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch import ROADMAP_HINT
from compactfusion_tpu_torch.utils.prof import annotate, count, tracing

#: bytes per element of the dtypes the kernels take (the ``ELEM`` of
#: ``RegLayout`` and ``WideLayout``)
ELEM_SIZES = {torch.bfloat16: 2, torch.float32: 4}
#: shared memory one CTA may take on an H100
SMEM_MAX = 227 * 1024
#: keys per K/V tile of the register body (``kRegBK`` in ``csrc/flash_reg.cuh``)
REG_BK = 64
#: keys per bf16 K/V tile of the wide body (``kWideBK`` in
#: ``csrc/flash_wide.cuh``; fp32 tiles hold half as many)
WIDE_BK = 32

#: the tile bodies a plan names, numbered as the C entry points take them:
#: ``flash_reg.cuh::flash_reg_tile`` (register fragments),
#: ``flash_wide.cuh::flash_wide_tile`` (register fragments, the head dim
#: split over warps and, above d = 512, over the CTAs of a cluster) and
#: ``flash_wgmma.cuh::flash_wgmma_tile`` (wgmma, TMA and a producer
#: warpgroup; its own entry points, ``cf_flash_wgmma`` and
#: ``cf_ring_flash_hop_wgmma``)
BODIES = {"flash_reg_tile": 1, "flash_wide_tile": 2, "flash_wgmma_tile": 3}
#: padded head dims of the register body
REG_DPS = (64, 80, 96, 128)
#: warps per CTA of the register body (16 query rows each), tried in this
#: order until a launch has MIN_CTAS CTAs; the last is taken regardless
REG_WARPS = (8, 4, 2)
#: the grid a register-body launch must reach where a tile height allows it
#: (about one CTA per SM of the 132)
MIN_CTAS = 128
#: (dp, warps) the register kernels are built for: ``CF_REG_PLANS`` in
#: ``csrc/flash_reg.cuh``, which lists every plan and nothing else
REG_BUILT = frozenset((dp, w) for dp in REG_DPS for w in REG_WARPS)
#: the kernels that take the wgmma body on bf16 q/k/v at d <= 128: kernel 1
#: and kernel 7 (kernel 8's flash partial is kernel 7's hop); kernel 4
#: keeps the register body
WG_KERNELS = frozenset((1, 7))
#: keys per K/V tile of the wgmma body (``kWgBK`` in ``csrc/flash_wgmma.cuh``)
WG_BK = 128
#: consumer warps per CTA of the wgmma body (16 query rows each, a
#: warpgroup per 64 rows): 128-row and 64-row tiles (:func:`flash_plan`)
WG_WARPS = (8, 4)
#: (dp, warps) the wgmma kernels are built for: ``CF_WG_PLANS`` in
#: ``csrc/flash_wgmma.cuh``, which lists every plan and nothing else
WG_BUILT = frozenset((dp, w) for dp in REG_DPS for w in WG_WARPS)
#: widest head-dim slice one warp of the wide body holds
WIDE_SLICE = 128
#: widest padded head dim one CTA of the wide body holds (``kWidePart`` in
#: ``csrc/flash_wide.cuh``), the most CTAs a cluster splits a head over
#: (``kWideMaxParts``), and so the widest head dim the kernels take
WIDE_PART = 512
WIDE_MAX_PARTS = 4
WIDE_MAX_D = WIDE_PART * WIDE_MAX_PARTS
#: row groups (16 query rows each, one warp per slice) per CTA of the wide
#: body: 32-row tiles.  At the VAE's B1 H1 S4096 d512 on an H100, 4 groups
#: (64-row tiles, 64 CTAs) took 0.4381 ms by CUDA graphs against 0.2943
#: (``tools/time_flash.py --sweep``, ``PERF.md`` §6)
WIDE_GROUPS = 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wide_parts(dp: int) -> int:
    """CTAs of a cluster that a wide-body plan of padded head dim ``dp``
    splits the head over, each holding ``dp // parts`` columns."""
    return -(-dp // WIDE_PART)


def wide_slices(dp: int) -> int:
    """Head-dim slices (warps per row group) of one CTA of a wide-body plan
    of padded head dim ``dp``."""
    return -(-(dp // wide_parts(dp)) // WIDE_SLICE)


def _part_dp(d: int) -> int:
    """One CTA's padded head dim for ``d`` <= 512 columns: ceil(d / 128)
    slices, each the smallest of :data:`REG_DPS` that holds its share of d
    rounded up to 16."""
    slices = -(-d // WIDE_SLICE)
    return slices * next(p for p in REG_DPS if p >= _round_up(-(-d // slices), 16))


def _wide_dp(d: int) -> int:
    """The wide body's padded head dim: ceil(d / 512) CTAs of one
    :func:`_part_dp` each, of their share of d rounded up to 8."""
    parts = -(-d // WIDE_PART)
    return parts * _part_dp(_round_up(-(-d // parts), 8))


#: padded head dims of one CTA of the wide body: every one the rule gives
WIDE_DPS = tuple(sorted({_part_dp(d) for d in range(REG_DPS[-1] + 8, WIDE_PART + 1, 8)}))
#: (dp, warps) of one CTA the wide kernels are built for: ``CF_WIDE_PLANS`` in
#: ``csrc/flash_wide.cuh`` (kernel 1 up to d = 512 on one CTA, kernels 4 and
#: 7 at every width on clusters of one or more)
WIDE_BUILT = frozenset((dp, WIDE_GROUPS * wide_slices(dp)) for dp in WIDE_DPS)
#: ... and those of kernel 1 above d = 512, on clusters of 2 or more CTAs:
#: ``CF_WIDE_SPLIT_PLANS``
WIDE_SPLIT_BUILT = frozenset((dp // wide_parts(dp), WIDE_GROUPS * wide_slices(dp))
                             for dp in map(_wide_dp, range(WIDE_PART + 8, WIDE_MAX_D + 1, 8)))


def reg_layout(dp: int, warps: int, elem: int = 2) -> dict:
    """The shared memory of one register-body CTA, as ``RegLayout<dp, warps,
    elem>`` in ``csrc/flash_reg.cuh`` lays it out: rows of ``ld`` elements
    (dp + 8 in bf16, dp + 4 in fp32: an odd number of 16-byte segments), the
    Q tile, ``stages`` K and V tiles of :data:`REG_BK` keys (3 where two CTAs
    of 3 stages share an SM, else 2), ``bytes`` in all."""
    ld = dp + 16 // elem
    q_bytes = 16 * warps * ld * elem
    tile_bytes = REG_BK * ld * elem
    stages = 3 if 2 * (q_bytes + 3 * 2 * tile_bytes) <= SMEM_MAX else 2
    return {"ld": ld, "q_bytes": q_bytes, "tile_bytes": tile_bytes, "stages": stages,
            "bytes": q_bytes + stages * 2 * tile_bytes}


def wgmma_layout(dp: int, warps: int) -> dict:
    """The shared memory of one wgmma-body CTA of ``warps`` consumer warps, as
    ``WgLayout<dp, warps>`` in ``csrc/flash_wgmma.cuh`` lays it out from a
    1024-byte aligned base: the Q tile (16 * warps rows), ``stages`` stages
    of a K and a V tile of :data:`WG_BK` keys, each ``wide`` blocks of 64
    columns (128-byte swizzle) and a block of ``tail`` columns (0, 16 or 32:
    32- or 64-byte swizzle), so d 72 and 88 stay at 80 and 96 columns, not
    128; then the barriers; up to 4 stages, and with one consumer warpgroup
    room for two CTAs an SM where two of 2 stages fit (``two_ctas``);
    ``bytes`` in all, the alignment slack included."""
    q_bytes, tile_bytes = 16 * warps * dp * 2, WG_BK * dp * 2
    fixed = q_bytes + 1024 + 256
    two_ctas = warps == 4 and 2 * (fixed + 2 * 2 * tile_bytes + 1024) <= 228 * 1024
    room = 228 * 1024 // 2 - 1024 if two_ctas else SMEM_MAX
    stages = min(4, (room - fixed) // (2 * tile_bytes))
    return {"wide": dp // 64, "tail": dp % 64, "q_bytes": q_bytes, "tile_bytes": tile_bytes,
            "two_ctas": two_ctas, "stages": stages, "bytes": fixed + stages * 2 * tile_bytes}


def wide_layout(dp: int, warps: int, elem: int = 2, split: bool = False) -> dict:
    """The shared memory of one wide-body CTA holding ``dp`` columns, as
    ``WideLayout<dp, warps, elem, split>`` in ``csrc/flash_wide.cuh`` lays it
    out: K/V tiles of ``bk`` keys (:data:`WIDE_BK` in bf16, half as many in
    fp32), rows of ``ld`` elements, the Q tile of its row groups, ``stages``
    K and V tiles and the exchange of partial scores (with ``split``, the
    kernels that may run on a cluster, also two buffers of the row groups'
    sums), ``bytes`` in all.  The ring takes 3 stages where they fit, but
    with ``split`` 2 where that lets two CTAs share an SM's 228 KB
    (``two_ctas``; the system keeps 1 KB of it per CTA)."""
    bk, ld = WIDE_BK * 2 // elem, dp + 16 // elem
    groups = warps // -(-dp // WIDE_SLICE)
    q_bytes = 16 * groups * ld * elem
    tile_bytes = bk * ld * elem
    xch_bytes = warps * 16 * bk * 4 + split * 2 * groups * 16 * bk * 4
    two_ctas = split and 2 * (q_bytes + 2 * 2 * tile_bytes + xch_bytes + 1024) <= 228 * 1024
    stages = 3 if not two_ctas and q_bytes + 3 * 2 * tile_bytes + xch_bytes <= SMEM_MAX else 2
    return {"bk": bk, "ld": ld, "q_bytes": q_bytes, "tile_bytes": tile_bytes, "xch_bytes": xch_bytes,
            "two_ctas": bool(two_ctas), "stages": stages, "bytes": q_bytes + stages * 2 * tile_bytes + xch_bytes}


def flash_plan(b: int, h: int, sq: int, d: int, elem: int = 2, kernel: Optional[int] = None) -> Tuple[str, int, int]:
    """(body, padded head dim, warps per CTA) of a flash launch of ``b``
    batches, ``h`` heads and ``sq`` queries of head dim ``d`` in ``elem``-byte
    elements (2: bf16, 4: fp32) for ``kernel`` (1, 4 or 7; kernel 8's flash
    partial asks as 7; None: the register and wide bodies' rule, which
    kernel 4, every fp32 launch and the stage probe take).

    Kernels 1 and 7 (:data:`WG_KERNELS`) on bf16 up to d = 128 take the
    wgmma body (``csrc/flash_wgmma.cuh``) at the register body's padded head
    dim, ``warps`` its consumer warps: 128-row tiles (8 warps, two consumer
    warpgroups sharing each K/V tile and taking turns at the tensor cores)
    where they give :data:`MIN_CTAS` CTAs, else 64-row tiles (4 warps, one
    warpgroup), however few CTAs those give.  On an H100 by CUDA graphs
    (``tools/time_flash.py --reg --sweep``, ``PERF.md`` §6), 128-row
    against 64-row tiles: FLUX's self-attention 0.4258 against 0.6071 ms,
    HunyuanDiT 0.4174 against 0.7689, PixArt-alpha 0.0332 against 0.0441,
    PixArt's ring-2 hop at B2 (128 CTAs) 0.0232 against 0.0300; with fewer
    than 128 CTAs 64-row tiles win: the ring-2 hop at B1 0.0167 against
    0.0196, a ring-8 hop (64 CTAs) 0.0343 against 0.0427, where the
    register body's 128 CTAs took 0.0560.  At DP 64 the two heights are
    close and split both ways (SD3 0.5524 against 0.5065, CogVideoX 10.64
    against 11.01), and the rule keeps one.  A row's result does not depend
    on the tile height, so cfg halves, Ulysses heads and ring shards stay
    bit-equal to the whole launch.

    Otherwise up to d = 128 (kernel 4, fp32, a launch with no key, the
    stage probe) the register body at the smallest of :data:`REG_DPS` that
    holds d rounded up to 16 (d=72 -> 80), with the tallest tile of
    :data:`REG_WARPS` that still gives :data:`MIN_CTAS` CTAs: 128-row tiles
    (8 warps) for PixArt's self-attention (256 CTAs; 8% faster than 4 warps
    on an H100) and a ring-2 hop at B2 (128), 64 rows at B1, 32 rows for a
    ring-8 hop or chunk (Sq = 128: 128 CTAs).  At Sq = 128 the CTA floor
    keeps a tile height that measured slower: 4 warps (64 CTAs) were 9%
    faster for a ring-8 hop of kernel 7 and 23% for kernel 1's chunk
    (``PERF.md`` §6; ROADMAP Queue 2, left #3).

    Banded attention (kernel 4) takes the same plan on its own kernel:
    128-row tiles at PixArt's B2 and at the CFG half (B1: 128 CTAs).  A
    taller tile reads more off-band keys per row (at w=64 a 128-row tile
    reads 256 keys, where a row needs 129) and a shorter one gives more
    CTAs; on an H100 at w=64 (``tools/time_flash.py --sweep``, ``PERF.md``
    §6) 8 warps took 0.0223 ms, 4 warps 0.0226 and 2 warps 0.0289 at B2,
    and 0.0122, 0.0126 and 0.0189 at the CFG half.

    Above d = 128 the wide body: the head dim in ceil(d / 512) parts, one CTA
    of a cluster each (:func:`wide_parts`), each part in ceil(part / 128)
    slices of one of :data:`REG_DPS` (d=512: 4 x 128; d=136: 2 x 80; d=576:
    2 CTAs of 3 x 96), one warp per (16-row group, slice), with
    :data:`WIDE_GROUPS` row groups a CTA (the VAE's B1 H1 S4096: 32-row
    tiles, 8 warps, 128 CTAs).  ``dp`` is the whole padded head dim, parts
    x one CTA's; ``warps`` those of one CTA.  Wider heads than
    :data:`WIDE_MAX_D` raise.

    fp32 takes the same plans: every one fits its fp32 layout
    (:func:`reg_layout`, :func:`wide_layout`; at DP 128 and 8 warps the
    register body holds 2 stages, 202,752 bytes, and at DP 512 the wide body
    2 stages of 16-key tiles, 206,336 bytes, 210,432 with the split's sums)."""
    if d % 8:
        raise ValueError(f"flash kernel: head dim must be a multiple of 8, got {d}")
    if elem not in ELEM_SIZES.values():
        raise ValueError(f"flash kernel: elements of 2 (bf16) or 4 (fp32) bytes, got {elem}")
    if d > WIDE_MAX_D:
        raise ValueError(f"flash kernel: head dim at most {WIDE_MAX_D} ({WIDE_MAX_PARTS} CTAs of {WIDE_PART} "
                         f"columns), got {d} ({ROADMAP_HINT})")
    if d <= REG_DPS[-1]:
        dp = next(p for p in REG_DPS if p >= _round_up(d, 16))
        if elem == 2 and kernel in WG_KERNELS:
            tall = b * h * math.ceil(sq / (16 * WG_WARPS[0])) >= MIN_CTAS
            warps = WG_WARPS[0] if tall else WG_WARPS[-1]
            assert wgmma_layout(dp, warps)["bytes"] <= SMEM_MAX
            return "flash_wgmma_tile", dp, warps
        for warps in REG_WARPS:
            if b * h * math.ceil(sq / (16 * warps)) >= MIN_CTAS:
                break
        assert reg_layout(dp, warps, elem)["bytes"] <= SMEM_MAX
        return "flash_reg_tile", dp, warps
    dp = _wide_dp(d)
    warps = WIDE_GROUPS * wide_slices(dp)
    assert wide_layout(dp // wide_parts(dp), warps, elem, split=True)["bytes"] <= SMEM_MAX
    return "flash_wide_tile", dp, warps


def plan_rows(plan: Tuple[str, int, int]) -> int:
    """Query rows per CTA of a plan: 16 a warp (on the wgmma body a consumer
    warp), or, on the wide body, 16 a row group of one warp per head-dim
    slice."""
    body, dp, warps = plan
    return 16 * warps // (wide_slices(dp) if body == "flash_wide_tile" else 1)


def plan_ctas(plan: Tuple[str, int, int], b: int, h: int, sq: int) -> int:
    """CTAs of a launch of ``b`` batches, ``h`` heads and ``sq`` queries at
    ``plan``: one per query tile, or on the wide body one per part of the
    head dim of each query tile."""
    body, dp, _ = plan
    return b * h * -(-sq // plan_rows(plan)) * (wide_parts(dp) if body == "flash_wide_tile" else 1)


def plan_args(plan: Tuple[str, int, int]) -> Tuple[int, int, int]:
    """A plan as the C entry points take it: (body id, dp, warps)."""
    body, dp, warps = plan
    return BODIES[body], dp, warps


def flash_attn_with_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: fp32 scores, fp32 natural-log LSE,
    probabilities rounded to v.dtype before the PV product (as the kernel
    does).  A row with no valid key gives 0 and LSE -inf.  It is the math
    path of ``attn_with_lse`` with no causal flag and no mask."""
    # imported here: ops.attention imports this module to route to the kernel
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, None, kv_lens)


def elem_size(dtype: torch.dtype) -> int:
    """Bytes per element of a dtype the kernels take; TypeError otherwise
    (fp16 is not ported)."""
    if dtype not in ELEM_SIZES:
        raise TypeError(f"flash kernel: q/k/v must be bfloat16 or float32, got {dtype} ({ROADMAP_HINT})")
    return ELEM_SIZES[dtype]


def _check_bshd(name: str, t: torch.Tensor, d: int) -> None:
    vec = 16 // elem_size(t.dtype)  # elements per 16-byte copy
    if t.dim() != 4 or t.shape[-1] != d:
        raise ValueError(f"flash kernel: {name} must be (B, S, H, {d}), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash kernel: {name} needs a unit head-dim stride, (b, s, h) strides "
            f"that are multiples of {vec} and a 16-byte aligned start; got strides "
            f"{t.stride()}"
        )


def _check_q(q) -> None:
    if q.shape[-1] % 8:
        raise ValueError(f"flash kernel: head dim must be a multiple of 8, got {q.shape[-1]}")
    _check_bshd("q", q, q.shape[-1])


def _check_kv(q, k, v) -> None:
    """k and v against a checked q: (B, S, H, D) views of q's dtype on q's
    device, of one shape that matches q in B, H and D."""
    b, _, h, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash kernel: {name} is {t.dtype}, q {q.dtype}")
        _check_bshd(name, t, d)
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} is on {t.device}, q on {q.device}")
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")


def _check_qkv(q, k, v) -> None:
    """The kernels' shared contract: bf16 or fp32 (B, S, H, D) views of one
    dtype on one device, d % 8 == 0, k and v of one shape that matches q in
    B, H and D."""
    _check_q(q)
    _check_kv(q, k, v)


def launch_plan(b: int, h: int, sq: int, d: int, dtype: torch.dtype, kernel: Optional[int] = None):
    """(:func:`flash_plan` of a launch of ``kernel`` on ``dtype`` q/k/v,
    whether it is fp32)."""
    return flash_plan(b, h, sq, d, elem=elem_size(dtype), kernel=kernel), dtype == torch.float32


def tma_view(name: str, t: torch.Tensor, dp: int, rows: int) -> dict:
    """The TMA tensor maps through which the wgmma body reads a bf16 (B, S,
    H, D) view ``t`` (``name``: q, k or v) in tiles of ``rows`` rows at
    padded head dim ``dp``, as ``cf_tma_map`` in ``csrc/flash_wgmma.cu``
    takes each: ``dims`` (D, S, H, B) in elements (S at least 1),
    ``strides`` the byte strides of S, H and B, and per map (the 64-column
    blocks', then at DP 80 and 96 the tail block's) its ``boxes`` (columns,
    rows, 1, 1) and ``swizzles`` (bytes: two per column).  Columns D..dp-1
    and rows past S read as zeros.  Raises on a view TMA cannot read (the
    kernels' contract: a unit head-dim stride, 16-byte multiples of the
    other strides and of the start)."""
    _check_bshd(name, t, t.shape[-1])
    b, s, h, d = t.shape
    e, widths = t.element_size(), (64,) + ((dp % 64,) if dp % 64 else ())
    return {"dims": (d, max(s, 1), h, b), "strides": (t.stride(1) * e, t.stride(2) * e, t.stride(0) * e),
            "boxes": tuple((w, rows, 1, 1) for w in widths), "swizzles": tuple(2 * w for w in widths)}


#: encoded tensor maps by (device, address, shape, strides, dp, rows): a map
#: holds no data, so a view of the same geometry at a recycled address takes
#: the map encoded for it before (a model's loop gets the same addresses from
#: the caching allocator step after step); emptied at TMA_CACHE_MAX entries
_TMA_MAPS: dict = {}
TMA_CACHE_MAX = 4096


def tma_map(lib, name: str, t: torch.Tensor, dp: int, rows: int) -> tuple:
    """The encoded TMA tensor maps of :func:`tma_view` (128-byte buffers, as
    the wgmma entry points take them: the 64-column boxes', then the
    tail's or None), from :data:`_TMA_MAPS` where they were encoded
    before."""
    key = (t.get_device(), t.data_ptr(), t.shape, t.stride(), dp, rows)
    maps = _TMA_MAPS.get(key)
    if maps is None:
        from compactfusion_tpu_torch.ops import _build

        view = tma_view(name, t, dp, rows)
        maps = []
        for box, swizzle in zip(view["boxes"], view["swizzles"]):
            buf = ctypes.create_string_buffer(128)
            status = lib.cf_tma_map(buf, t.data_ptr(), *view["dims"], *view["strides"], *box[:2], swizzle)
            _build.check(status, f"TMA tensor map of {name} {tuple(t.shape)} strides {t.stride()}")
            maps.append(buf)
        maps = (maps[0], maps[1] if len(maps) > 1 else None)
        if len(_TMA_MAPS) >= TMA_CACHE_MAX:
            _TMA_MAPS.clear()
        _TMA_MAPS[key] = maps
    return maps


def flash_attn_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    plan: Optional[Tuple[str, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D), k/v (B, Sk, H, D), bf16 or fp32 -> out (B, Sq, H, D)
    in q.dtype and lse (B, H, Sq) fp32.  ``kv_lens`` (B,) int: per-batch
    valid key prefix.
    ``window``: banded attention |i - j| <= window, delegated to
    :func:`flash_attn_window_with_lse` (Sq == Sk, no ``kv_lens``).
    ``plan``: a plan of :func:`flash_plan` to launch instead of kernel 1's
    own, for tools and probes that hold or time one body against another
    (the stage probe's register body); the model path never passes one.
    A launch with no key (Sk = 0) takes the register body: a tensor map
    cannot describe an empty tensor."""
    if window is not None:
        if kv_lens is not None:
            raise ValueError("flash kernel: window excludes kv_lens masking")
        return flash_attn_window_with_lse(q, k, v, window, scale=scale)
    if not q.is_cuda:
        return flash_attn_with_lse_ref(q, k, v, scale=scale, kv_lens=kv_lens)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lens_ptr = None
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_lens.shape != (b,):
            raise ValueError(f"flash kernel: kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
        lens_ptr = kv_lens.data_ptr()
    if scale is None:
        scale = d**-0.5

    f32 = q.dtype == torch.float32
    if plan is None:
        plan, _ = launch_plan(b, h, sq, d, q.dtype, kernel=1 if sk else None)
    elif plan[0] == "flash_wgmma_tile" and f32:
        raise ValueError("flash kernel: the wgmma body takes bf16 q/k/v")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan[0] == "flash_wgmma_tile":
        _, dp, warps = plan
        status = lib.cf_flash_wgmma(
            *tma_map(lib, "q", q, dp, plan_rows(plan)), *tma_map(lib, "k", k, dp, WG_BK), *tma_map(lib, "v", v, dp, WG_BK),
            out.data_ptr(), lse.data_ptr(), lens_ptr, b, sq, sk, h, d, ctypes.c_float(scale), dp, warps, stream,
        )
    else:
        status = lib.cf_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            out.data_ptr(), lse.data_ptr(), lens_ptr,
            b, sq, sk, h, d, ctypes.c_float(scale), *plan_args(plan), int(f32), stream,
        )
    _build.check(status, "flash_attn_with_lse")
    # the Profiler's counters: launches, those on the wide body, on the wgmma
    # body, on fp32 q/k/v, and on fp32 q/k/v on the wide body
    wide = plan[0] == "flash_wide_tile"
    count("flash_attn_with_lse.launches")
    count("flash_attn_with_lse.wide_launches", wide)
    count("flash_attn_with_lse.wgmma_launches", plan[0] == "flash_wgmma_tile")
    count("flash_attn_with_lse.f32_launches", f32)
    count("flash_attn_with_lse.f32_wide_launches", f32 and wide)
    launched(plan)
    return out, lse


def launched(plan: Tuple[str, int, int]):
    """Count a flash launch under its tile body (``flash.body.<body>``)
    and, while tracing, put its route on the innermost open span (the
    ``attention`` span of a block)."""
    count(f"flash.body.{plan[0]}")
    if tracing():
        annotate({"body": plan[0], "dp": plan[1], "warps": plan[2]})


def window_mask(s: int, window: int, device=None) -> torch.Tensor:
    """(S, S) banded mask: True where |i - j| <= window."""
    idx = torch.arange(s, device=device)
    return (idx[:, None] - idx[None, :]).abs() <= window


def flash_attn_window_with_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the banded kernel: the math path of
    ``attn_with_lse`` with the band mask |i - j| <= window (every row keeps
    its own key, so no row is empty)."""
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, window_mask(q.shape[1], window, q.device), None)


def flash_attn_window_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded self-attention |i - j| <= window with LSE (the ``window=``
    branch of the JAX ``flash_attn_with_lse``): q/k/v (B, S, H, D) -> out
    (B, S, H, D) in q.dtype, lse (B, H, S) fp32.  The kernel visits only the
    KV tiles that each query tile's band touches, so its work scales with
    S * window; :func:`flash_plan` names its body and tile."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"windowed attention is for self-attention (Sq == Sk), got "
                         f"Sq {q.shape[1]}, Sk {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not q.is_cuda:
        return flash_attn_window_with_lse_ref(q, k, v, window, scale=scale)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    plan, f32 = launch_plan(b, h, s, d, q.dtype)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.cf_flash_attn_window(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.data_ptr(), lse.data_ptr(),
        b, s, h, d, min(int(window), s), ctypes.c_float(scale), *plan_args(plan), int(f32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attn_window_with_lse")
    count("flash_attn_window_with_lse.launches")
    count("flash_attn_window_with_lse.f32_launches", f32)
    launched(plan)
    return out, lse
