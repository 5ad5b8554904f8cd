"""Compression codecs, binary subset (counterpart of ``compactfusion_tpu/compact/codecs.py``).

A payload is a NamedTuple of tensors: packed uint8 signs plus bf16 scale
factors.  Only BINARY with the mean scale (``comp_rank=-1``) is ported; rank
>= 1 needs ``lowrank.subspace_iter`` and the other codecs wait (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from compactfusion_tpu_torch import ROADMAP_HINT
from compactfusion_tpu_torch.compact.packing import pack_bits, unpack_bits
from compactfusion_tpu_torch.config import CompressType

SCALE_DTYPE = torch.bfloat16
_EPS = 1e-6


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Round a payload field to the wire dtype.  Eager PyTorch performs the
    rounding (the JAX package needs an optimization barrier so XLA does not
    elide the f32->bf16->f32 pair)."""
    return x.to(SCALE_DTYPE)


class BinaryPayload(NamedTuple):
    """1-bit signs packed along C + rank-k scale factors U (N,k), V (k,C)."""

    packed: torch.Tensor  # (N, C//8) uint8
    scale_u: torch.Tensor  # (N, k) bf16
    scale_v: torch.Tensor  # (k, C) bf16


def _mean_scale_uv(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-based rank-1 scale: U = normalized per-token mean, V = channel mean."""
    a = x32.abs()
    chan = a.mean(dim=0, keepdim=True)  # (1, C)
    tok = a.mean(dim=1, keepdim=True)  # (N, 1)
    tok = tok / (tok.mean() + _EPS)
    return tok, chan


def _scale_uv(x32: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if rank == -1:
        return _mean_scale_uv(x32)
    raise NotImplementedError(f"rank-{rank} scale model (lowrank.subspace_iter): {ROADMAP_HINT}")


def encode_binary(x: torch.Tensor, rank: int = -1) -> BinaryPayload:
    x32 = x.float()
    u, v = _scale_uv(x32, rank)
    return BinaryPayload(pack_bits(x32 >= 0), _wire(u), _wire(v))


def decode_binary(p: BinaryPayload, dtype=torch.float32) -> torch.Tensor:
    sign = unpack_bits(p.packed).float() * 2.0 - 1.0
    scale = p.scale_u.float() @ p.scale_v.float()
    return (sign * scale).to(dtype)


def encode(x: torch.Tensor, method: CompressType, *, rank: int = -1):
    """Compress an (N, C) tensor (IDENTITY/WARMUP pass it through)."""
    if method in (CompressType.IDENTITY, CompressType.WARMUP):
        return x
    if method == CompressType.BINARY:
        return encode_binary(x, rank)
    raise NotImplementedError(f"{method.value} codec: {ROADMAP_HINT}")


def decode(payload, method: CompressType, *, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`encode`."""
    if method in (CompressType.IDENTITY, CompressType.WARMUP):
        return payload.to(dtype)
    if method == CompressType.BINARY:
        return decode_binary(payload, dtype)
    raise NotImplementedError(f"{method.value} codec: {ROADMAP_HINT}")
