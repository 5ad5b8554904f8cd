"""The compressed all-gather: CompactFusion's patch-parallel transport
(counterpart of ``compactfusion_tpu/compact/allgather.py``).

Each rank compresses its own tensor against its own EF slot without
updating it, the payloads are all-gathered, and then every rank
decompresses all W payloads in source order, each against that source's
slot, updating every slot.  After the call every rank holds the same W
reconstructions and the same W slots, and the own slot holds what the
sender's quant would have written (the error-feedback invariant).  On CUDA
tensors the BINARY and INT2 codecs go through the fused quant and dequant
kernels (``compact/engine.py``'s fast path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.compact.engine import EFState, ef_compress, ef_decompress
from compactfusion_tpu_torch.compact.ring import set_slot, slot, tree_map
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, Mesh


def compact_all_gather(x_nc: torch.Tensor, state: EFState, *, cfg: CompactConfig, method: CompressType,
                       mesh: Optional[Mesh], axis: str = AXIS_RING) -> Tuple[torch.Tensor, EFState]:
    """All-gather with delta compression and error feedback.

    ``x_nc`` (N, C) this rank's tensor; ``state`` the per-source EF caches,
    leaves (W, N, C), updated in place.  Returns (the W reconstructions
    (W, N, C) in source-rank order, state)."""
    world = 1 if mesh is None else mesh.axis_size(axis)
    my = 0 if world == 1 else mesh.axis_index(axis)
    # the own slot is not updated here: every rank updates every slot alike
    # when it decodes the gathered payloads below
    payload, _ = ef_compress(x_nc, slot(state, my), cfg, method, update_cache=False)
    payloads = (tree_map(lambda a: a[None], payload) if world == 1
                else mesh.all_gather_tree(payload, axis))
    gathered = []
    for src in range(world):
        x_hat, new = ef_decompress(tree_map(lambda a: a[src], payloads), slot(state, src), cfg, method,
                                   update_cache=True)
        set_slot(state, src, new)
        gathered.append(x_hat)
    return torch.stack(gathered), state
