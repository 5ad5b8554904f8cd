"""Ulysses sequence parallelism: an all-to-all that swaps sequence sharding
for head sharding (counterpart of ``compactfusion_tpu/parallel/ulysses.py``).

Before attention each rank scatters its heads and gathers the sequence,
so it holds the whole (ring-local) sequence for H/U heads; after attention
the inverse.  Each is one tiled all-to-all over the ``ulysses`` axis of the
mesh (:meth:`parallel.mesh.Mesh.all_to_all`).
"""

from __future__ import annotations

import torch

from compactfusion_tpu_torch.parallel.mesh import AXIS_ULYSSES, Mesh


def scatter_heads_gather_seq(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_ULYSSES) -> torch.Tensor:
    """(B, S_local, H, D) -> (B, S_local * U, H / U, D)."""
    return mesh.all_to_all(x, axis, split_dim=2, concat_dim=1)


def scatter_seq_gather_heads(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_ULYSSES) -> torch.Tensor:
    """(B, S_local * U, H / U, D) -> (B, S_local, H, D), the inverse."""
    return mesh.all_to_all(x, axis, split_dim=1, concat_dim=2)


def slice_joint_heads(x: torch.Tensor, mesh: Mesh, ulysses_size: int,
                      axis: str = AXIS_ULYSSES) -> torch.Tensor:
    """This Ulysses rank's contiguous head block of a replicated joint
    (text) tensor (B, Sj, H, D) -> (B, Sj, H / U, D), a view: after the
    all-to-all each rank owns that block of every head-sharded tensor."""
    per = x.shape[2] // ulysses_size
    return x.narrow(2, mesh.axis_index(axis) * per, per)
