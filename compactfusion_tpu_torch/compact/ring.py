"""Per-source EF caches of the compressed ring
(counterpart of the state part of ``compactfusion_tpu/compact/ring.py``).

Each ring rank keeps one EF state pair per source rank; here they are
stacked on a leading ring-slot axis.  The ring itself (``compact_ring_attention``
across GPUs) is not ported yet; the single-device emulation
``models/attn_impl.SimRingAttn`` uses this state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from compactfusion_tpu_torch.compact.engine import EFState, init_ef_state


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


def _slot(state: EFState, i: int) -> EFState:
    """Ring slot i of a stacked EF state (views into the stack)."""
    return tree_map(lambda a: a[i], state)


def _set_slot(state: EFState, i: int, new: EFState) -> EFState:
    """Write ``new`` into ring slot i IN PLACE (the stack is reused rather
    than copied per update, which keeps one (R, N, C) buffer per layer).
    Works leaf by leaf, so int8-quantized entries update the same way."""
    tree_map(lambda a, n: a[i].copy_(n), state, new)
    return state
