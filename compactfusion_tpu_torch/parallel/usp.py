"""USP: hybrid Ulysses x Ring sequence-parallel attention
(counterpart of ``compactfusion_tpu/parallel/usp.py``).

The joint (text) query joins the local query; the Ulysses all-to-all
scatters heads and gathers the sequence, and the replicated joint K/V are
cut to this rank's head block; then ring attention, plain or compressed;
then the inverse all-to-all.  ``sp_degree = ulysses_degree * ring_degree``.
The plain and the compressed USP attention share :func:`usp_wrap`, so
their joint and Ulysses handling cannot diverge.
"""

from __future__ import annotations

from typing import Optional

import torch

from compactfusion_tpu_torch.parallel import ulysses as uly
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, AXIS_ULYSSES, Mesh
from compactfusion_tpu_torch.parallel.ring import ring_attention


def usp_wrap(inner, q, k, v, *, ulysses_size: int, mesh: Optional[Mesh] = None,
             ulysses_axis: str = AXIS_ULYSSES, joint_q=None, joint_k=None, joint_v=None,
             joint_strategy: str = "none"):
    """Joint-q concat -> Ulysses all-to-all (scatter heads, gather the
    sequence; the replicated joint K/V cut to this rank's heads) ->
    ``inner(q, k, v, joint_k, joint_v) -> (out, aux)`` -> inverse all-to-all
    on out.  The joint query rows are in every Ulysses rank's chunk, so
    after the gather they are computed U times, as in the JAX package."""
    if joint_q is not None:
        if joint_strategy == "front":
            q = torch.cat([joint_q, q], dim=1)
        elif joint_strategy == "rear":
            q = torch.cat([q, joint_q], dim=1)
        else:
            raise ValueError(f"joint_strategy {joint_strategy!r} with joint_q")
    if ulysses_size > 1:
        if mesh is None:
            raise ValueError(f"Ulysses (ulysses_size={ulysses_size}) needs this rank's mesh")
        q, k, v = (uly.scatter_heads_gather_seq(t, mesh, ulysses_axis) for t in (q, k, v))
        if joint_k is not None:
            joint_k = uly.slice_joint_heads(joint_k, mesh, ulysses_size, ulysses_axis)
            joint_v = uly.slice_joint_heads(joint_v, mesh, ulysses_size, ulysses_axis)
    out, aux = inner(q, k, v, joint_k, joint_v)
    if ulysses_size > 1:
        out = uly.scatter_seq_gather_heads(out, mesh, ulysses_axis)
    return out, aux


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

    out, _ = usp_wrap(inner, q, k, v, ulysses_size=ulysses_size, mesh=mesh, joint_q=joint_q,
                      joint_k=joint_k, joint_v=joint_v, joint_strategy=joint_strategy)
    return out
