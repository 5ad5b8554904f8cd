"""1-bit packing along channels, grouped layout
(counterpart of ``compactfusion_tpu/compact/packing.py``).

The C channels split into 8 contiguous groups of C/8; byte j carries bit i
from channel ``i*(C/8)+j``.  The bytes equal the JAX package's.  The 2-bit
and 4-bit packers are not ported yet.
"""

from __future__ import annotations

import torch


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (N, C) {0,1} (any integer or bool dtype) into (N, C//8) uint8."""
    n, c = bits.shape
    if c % 8:
        raise ValueError(f"C={c} must be divisible by 8")
    g = c // 8
    b = bits.to(torch.uint8)
    out = b[:, :g].clone()
    for i in range(1, 8):
        out |= b[:, i * g : (i + 1) * g] << i
    return out


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> (N, C) uint8 in {0,1}."""
    return torch.cat([(packed >> i) & 1 for i in range(8)], dim=1)
