"""USP: hybrid Ulysses x Ring sequence-parallel attention
(counterpart of ``compactfusion_tpu/parallel/usp.py``).

The joint (text) query joins the local query; then (with Ulysses, not
ported yet) an all-to-all would scatter heads and gather the sequence;
then ring attention, plain or compressed.  The plain and the compressed
USP attention share :func:`usp_wrap`, so their joint handling cannot
diverge.
"""

from __future__ import annotations

from typing import Optional

import torch

from compactfusion_tpu_torch import ROADMAP_HINT
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, Mesh
from compactfusion_tpu_torch.parallel.ring import ring_attention


def usp_wrap(inner, q, k, v, *, ulysses_size: int, joint_q=None, joint_k=None, joint_v=None,
             joint_strategy: str = "none"):
    """Joint-q concat -> ``inner(q, k, v, joint_k, joint_v) -> (out, aux)``.
    ``ulysses_size > 1`` raises: the Ulysses all-to-all is not ported."""
    if ulysses_size > 1:
        raise NotImplementedError(f"Ulysses (ulysses_size={ulysses_size}): {ROADMAP_HINT}")
    if joint_q is not None:
        if joint_strategy == "front":
            q = torch.cat([joint_q, q], dim=1)
        elif joint_strategy == "rear":
            q = torch.cat([q, joint_q], dim=1)
        else:
            raise ValueError(f"joint_strategy {joint_strategy!r} with joint_q")
    return inner(q, k, v, joint_k, joint_v)


def usp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Optional[Mesh],
    ulysses_size: int = 1,
    ring_axis: str = AXIS_RING,
    scale: Optional[float] = None,
    causal: bool = False,
    joint_q: Optional[torch.Tensor] = None,
    joint_k: Optional[torch.Tensor] = None,
    joint_v: Optional[torch.Tensor] = None,
    joint_strategy: str = "none",
    fused_ring: bool = False,
) -> torch.Tensor:
    """Sequence-parallel attention on this rank's shards: q/k/v (B,
    S_local, H, D); joint_q/k/v (B, Sj, H, D) replicated, joint_q joined to
    q per ``joint_strategy`` (the caller strips those output rows).
    Returns (B, S_local (+Sj), H, D)."""

    def inner(q, k, v, joint_k, joint_v):
        out = ring_attention(q, k, v, mesh=mesh, axis=ring_axis, scale=scale, causal=causal,
                             joint_k=joint_k, joint_v=joint_v, joint_strategy=joint_strategy,
                             fused=fused_ring)
        return out, None

    out, _ = usp_wrap(inner, q, k, v, ulysses_size=ulysses_size, joint_q=joint_q,
                      joint_k=joint_k, joint_v=joint_v, joint_strategy=joint_strategy)
    return out
