"""Sub-byte packing along channels, grouped layout
(counterpart of ``compactfusion_tpu/compact/packing.py``).

The C channels split into 8 (1-bit), 4 (2-bit) or 2 (4-bit) contiguous
groups; byte j carries bit i from channel ``i*(C/8)+j``, crumb i from
channel ``i*(C/4)+j``, or channel j in the low nibble and ``C/2+j`` in the
high one.  The bytes equal the JAX package's.
"""

from __future__ import annotations

import torch


def _pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (N, C) codes of ``bits`` bits into (N, C*bits//8) uint8."""
    n, c = codes.shape
    per = 8 // bits
    if c % per:
        raise ValueError(f"C={c} must be divisible by {per}")
    g = c // per
    q = codes.to(torch.uint8)
    out = q[:, :g].clone()
    for i in range(1, per):
        out |= q[:, i * g : (i + 1) * g] << (bits * i)
    return out


def _unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    mask = (1 << bits) - 1
    return torch.cat([(packed >> (bits * i)) & mask for i in range(8 // bits)], dim=1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (N, C) {0,1} (any integer or bool dtype) into (N, C//8) uint8."""
    return _pack(bits, 1)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> (N, C) uint8 in {0,1}."""
    return _unpack(packed, 1)


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack (N, C) codes in [0, 3] into (N, C//4) uint8."""
    return _pack(codes, 2)


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    return _unpack(packed, 2)


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack (N, C) codes in [0, 15] into (N, C//2) uint8."""
    return _pack(codes, 4)


def unpack_4bit(packed: torch.Tensor) -> torch.Tensor:
    return _unpack(packed, 4)
