"""The compressed ring: the CompactFusion hot path
(counterpart of ``compactfusion_tpu/compact/ring.py``).

Each rank compresses its own K/V once against its own EF slot, the
compressed payload circulates around the ring (``parallel/ring.ring_shift``),
and every hop decompresses it against the slot of its source rank, so each
rank keeps R base pairs per layer, identical on every rank (the
error-feedback consistency invariant, checked by ``check_consistency``).
The caches are stacked on a leading ring-slot axis and updated in place.

Two routes, one decision made the same way on every rank (both ends of a
ring must pack alike): the unfused ring (``ef_compress`` / ``ef_decompress``
and a flash partial per hop, every codec) and, with ``fused`` and residual
1 + error feedback on BINARY, INT2, LOW_RANK or LOW_RANK_AWL, the fused
compressed ring kernel (``ops/ring_flash.compact_ring_flash``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from compactfusion_tpu_torch.compact import codecs, stats
from compactfusion_tpu_torch.compact.engine import (
    EFState,
    check_consistency,
    ef_compress,
    ef_decompress,
    init_ef_state,
)
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.ops.attention import attn_with_lse
from compactfusion_tpu_torch.ops.merge import merge_out_lse
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, Mesh
from compactfusion_tpu_torch.parallel.ring import with_joint, ring_blocks
from compactfusion_tpu_torch.utils import collector


class CompactRingState(NamedTuple):
    """Per-layer EF caches for every ring source (leading axis = ring slot)."""

    k: EFState  # leaves (R, N, C)
    v: EFState  # leaves (R, N, C)


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over matching NamedTuples/tuples of tensors;
    ``None`` leaves stay ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    mapped = [tree_map(fn, *parts) for parts in zip(*trees)]
    return type(first)(*mapped) if hasattr(first, "_fields") else type(first)(mapped)


def init_ring_state(ring_size: int, tokens: int, channels: int, dtype=torch.bfloat16,
                    residual: int = 1, quantized: bool = False, device=None,
                    layers: int = 0) -> CompactRingState:
    """Initial caches with leaves (R, N, C), or (layers, R, N, C) when
    ``layers``; with ``quantized`` each entry is an ``Int8Payload`` of the
    zero cache (its scale is not 0, so the slots are copies of one slot)."""
    lead = (layers, ring_size) if layers else (ring_size,)
    one = init_ef_state((tokens, channels), dtype, residual, quantized, device)

    def stacked(a):
        return a.expand(lead + tuple(a.shape)).clone(memory_format=torch.contiguous_format)

    return CompactRingState(k=tree_map(stacked, one), v=tree_map(stacked, one))


def slot(state: EFState, i: int) -> EFState:
    """Ring slot i of a stacked EF state (views into the stack)."""
    return tree_map(lambda a: a[i], state)


def set_slot(state: EFState, i: int, new: EFState) -> EFState:
    """Write ``new`` into ring slot i IN PLACE (the stack is reused rather
    than copied per update, which keeps one (R, N, C) buffer per layer).
    Works leaf by leaf, so int8-quantized entries update the same way."""
    tree_map(lambda a, n: a[i].copy_(n), state, new)
    return state


def _as_nc(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*S, H*D), the (token, channel) codec layout."""
    b, s, h, d = x.shape
    return x.reshape(b * s, h * d)


_FUSED_CODECS = {
    CompressType.BINARY: "binary",
    CompressType.INT2: "int2",
    CompressType.LOW_RANK: "lowrank",
    CompressType.LOW_RANK_AWL: "lowrank",
}


def _fused_route(q, k, state: CompactRingState, cfg: CompactConfig, method: CompressType,
                 ring_size: int, fused: bool) -> bool:
    """The JAX package's conditions for the fused compressed ring, as they
    are (its backend test becomes the kernel wrapper's device test)."""
    b, _, _, d = k.shape
    return bool(
        fused
        and ring_size > 1
        and method in _FUSED_CODECS
        and (cfg.comp_rank >= 1 or method in (CompressType.BINARY, CompressType.INT2))
        and cfg.residual == 1
        and cfg.error_feedback
        and not cfg.simulate
        # int8 EF caches at B == 1: the kernel requantizes per (head,
        # channel) over one batch row's tokens
        and (not cfg.quantized_cache or b == 1)
        and not cfg.log_stats
        # the fused kernel has no collector taps: the unfused ring keeps the
        # offline-analysis dumps complete
        and not collector.enabled()
        and q.shape[1] % 8 == 0
        and d % 8 == 0
        and state.k.delta_base is None
    )


def _fused_compact_ring(q, k, v, state: CompactRingState, cfg: CompactConfig, method, mesh: Mesh,
                        axis, scale, joint_k, joint_v, joint_strategy):
    """The sender's payload from its own slot, then one kernel launch per
    hop (``ops/ring_flash.compact_ring_flash``) updating every slot in
    place; the replicated joint block merges after."""
    from compactfusion_tpu_torch.ops.ring_flash import (
        compact_ring_flash,
        decode_slot,
        fused_ring_payload,
    )

    codec = _FUSED_CODECS[method]
    my, ring_size = mesh.axis_index(axis), mesh.axis_size(axis)
    awl_k = codecs.awl_row_scale(_as_nc(v)) if method == CompressType.LOW_RANK_AWL else None
    payload = fused_ring_payload(k, v, decode_slot(state.k.base, my), decode_slot(state.v.base, my),
                                 codec, cfg.comp_rank, awl_k)
    out, lse = compact_ring_flash(q, k, v, state.k.base, state.v.base,
                                  ring_blocks(payload, mesh, axis), codec=codec, my=my,
                                  ring_size=ring_size, scale=scale)
    if joint_k is not None and joint_strategy != "none":
        j_out, j_lse = attn_with_lse(q, joint_k, joint_v, scale=scale)
        out, lse = merge_out_lse(out, lse, j_out, j_lse)
    return out.to(q.dtype), state


def compact_ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    state: CompactRingState,
    *,
    cfg: CompactConfig,
    method: CompressType,
    mesh: Optional[Mesh],
    axis: str = AXIS_RING,
    scale: Optional[float] = None,
    joint_k: Optional[torch.Tensor] = None,
    joint_v: Optional[torch.Tensor] = None,
    joint_strategy: str = "none",
    fused: bool = False,
) -> Tuple[torch.Tensor, CompactRingState]:
    """Ring attention exchanging compressed K/V deltas.

    This rank's q/k/v (B, S_local, H, D); ``state`` this layer's caches,
    leaves (R, N, C), updated in place (the own slot at compress time, each
    source slot at decompress time) and returned.  ``method`` is the codec
    of this denoise step (WARMUP sends the raw K/V).  ``fused`` takes the
    fused compressed ring where its conditions hold (:func:`_fused_route`).
    Returns (out in q.dtype, state).

    Taps (unfused route), as the JAX package's: with ``CFTPU_COLLECT_DIR``
    the collector dumps this rank's q/k/v and its post-EF bases (``kbase``,
    ``vbase``) under the ring index; with ``cfg.log_stats`` and a codec
    other than WARMUP and IDENTITY on dense caches, the spectra of K and of
    its delta against the own slot, and, at residual 1 + EF, the K and V
    codec error against the post-EF base (keys tagged ``@r{ring index}``
    when the mesh spans more than one rank)."""
    ring_size = 1 if mesh is None else mesh.axis_size(axis)
    if _fused_route(q, k, state, cfg, method, ring_size, fused):
        out, state = _fused_compact_ring(q, k, v, state, cfg, method, mesh, axis, scale,
                                         joint_k, joint_v, joint_strategy)
        if cfg.check_consistency:
            consistency_assert(state, mesh, axis)
        return out, state

    kv_shape = tuple(k.shape)
    my = 0 if ring_size == 1 else mesh.axis_index(axis)
    if collector.enabled():
        for name, t in (("q", q), ("k", k), ("v", v)):
            collector.collect(t, name, rank=my)
    taps = cfg.log_stats and not cfg.quantized_cache and method not in (CompressType.WARMUP,
                                                                        CompressType.IDENTITY)
    tag = my if mesh is not None and mesh.parallel.world_size > 1 else None
    if taps:
        k_nc = _as_nc(k).float()
        stats.log_spectrum_inside_jit("k-activation", k_nc, rank=tag)
        stats.log_spectrum_inside_jit("k-delta", k_nc - slot(state.k, my).base.float(), rank=tag)
    # sender: compress the own K/V against the own slot (update_cache=True)
    awl = codecs.awl_row_scale(_as_nc(v)) if method == CompressType.LOW_RANK_AWL else None
    payload_k, k_own = ef_compress(_as_nc(k), slot(state.k, my), cfg, method, awl_scale=awl)
    payload_v, v_own = ef_compress(_as_nc(v), slot(state.v, my), cfg, method)
    if taps and cfg.residual == 1 and cfg.error_feedback:
        stats.log_inside_jit("k", -1, stats.compression_metrics(_as_nc(k), k_own.base), rank=tag)
        stats.log_inside_jit("v", -1, stats.compression_metrics(_as_nc(v), v_own.base), rank=tag)
    if collector.enabled() and isinstance(k_own.base, torch.Tensor):
        collector.collect(k_own.base, "kbase", rank=my)
        collector.collect(v_own.base, "vbase", rank=my)
    set_slot(state.k, my, k_own)
    set_slot(state.v, my, v_own)

    if ring_size == 1:
        kk, vv = with_joint(k, v, joint_k, joint_v, joint_strategy, 0, 1)
        out, _ = attn_with_lse(q, kk, vv, scale=scale)
        return out.to(q.dtype), state

    out = lse = None
    for step, (pk, pv) in enumerate(ring_blocks((payload_k, payload_v), mesh, axis)):
        if step > 0:
            src = (my - step) % ring_size
            x_k, k_src = ef_decompress(pk, slot(state.k, src), cfg, method)
            x_v, v_src = ef_decompress(pv, slot(state.v, src), cfg, method)
            set_slot(state.k, src, k_src)
            set_slot(state.v, src, v_src)
            blk_k = x_k.reshape(kv_shape).to(k.dtype)
            blk_v = x_v.reshape(kv_shape).to(v.dtype)
        else:
            # step 0 attends the local exact K/V
            blk_k, blk_v = k, v
        kk, vv = with_joint(blk_k, blk_v, joint_k, joint_v, joint_strategy, step, ring_size)
        block_out, block_lse = attn_with_lse(q, kk, vv, scale=scale)
        out, lse = merge_out_lse(out, lse, block_out, block_lse)

    if cfg.check_consistency:
        consistency_assert(state, mesh, axis)
    return out.to(q.dtype), state


#: the largest cache deviation across ranks that ``consistency_assert``
#: has seen in this process (set it to 0.0 to start a new count)
max_consistency_dev = 0.0


def consistency_assert(state: CompactRingState, mesh: Mesh, axis: str) -> None:
    """Every cache slot must be the same on every ring rank after the
    exchange (the reference's ``check_consistency`` at the end of the
    ring); raises AssertionError past 1e-2, as the JAX package does."""
    global max_consistency_dev
    dk = check_consistency(state.k, mesh, axis).item()
    dv = check_consistency(state.v, mesh, axis).item()
    max_consistency_dev = max(max_consistency_dev, dk, dv)
    if not (dk < 1e-2 and dv < 1e-2):
        raise AssertionError(f"EF cache divergence across ring ranks: k={dk} v={dv}")


def compact_usp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    state: CompactRingState,
    *,
    cfg: CompactConfig,
    method: CompressType,
    mesh: Optional[Mesh],
    ulysses_size: int = 1,
    ring_axis: str = AXIS_RING,
    scale: Optional[float] = None,
    joint_q: Optional[torch.Tensor] = None,
    joint_k: Optional[torch.Tensor] = None,
    joint_v: Optional[torch.Tensor] = None,
    joint_strategy: str = "none",
    fused: bool = False,
) -> Tuple[torch.Tensor, CompactRingState]:
    """USP with the compressed ring as its inner loop (the joint and
    Ulysses handling of ``parallel/usp.usp_wrap``, shared with the plain USP
    attention).  ``state``'s leaves are (R, N, C) at the ring loop's
    shapes, after the all-to-all: N = B * S_local * U, C = (H / U) * D."""
    from compactfusion_tpu_torch.parallel.usp import usp_wrap

    def inner(q, k, v, joint_k, joint_v):
        return compact_ring_attention(q, k, v, state, cfg=cfg, method=method, mesh=mesh,
                                      axis=ring_axis, scale=scale, joint_k=joint_k,
                                      joint_v=joint_v, joint_strategy=joint_strategy, fused=fused)

    return usp_wrap(inner, q, k, v, ulysses_size=ulysses_size, mesh=mesh, joint_q=joint_q, joint_k=joint_k,
                    joint_v=joint_v, joint_strategy=joint_strategy)
