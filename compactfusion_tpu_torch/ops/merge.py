"""Online-softmax merge of partial attention results
(counterpart of ``compactfusion_tpu/ops/merge.py``).

Combines per-block attention partials (out_i, lse_i) into the exact global
softmax result, in fp32, as the ring loops do after every hop.  Plain
torch: the JAX package has no kernel here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def merge_out_lse(
    out: Optional[torch.Tensor],
    lse: Optional[torch.Tensor],
    block_out: torch.Tensor,
    block_lse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a new block into the running (out, lse) accumulator.

    ``out`` (B, S, H, D) fp32 and ``lse`` (B, H, S) fp32, or None on the
    first block; ``block_out`` (B, S, H, D), ``block_lse`` (B, H, S).
    Returns the merged (out, lse) in fp32."""
    block_out = block_out.float()
    block_lse = block_lse.float()
    if out is None:
        return block_out, block_lse
    new_lse = torch.logaddexp(lse, block_lse)
    # weights (B, H, S) -> (B, S, H, 1)
    w_old = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(block_lse - new_lse).transpose(1, 2)[..., None]
    return out * w_old + block_out * w_new, new_lse
