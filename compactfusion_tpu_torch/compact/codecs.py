"""Compression codecs (counterpart of ``compactfusion_tpu/compact/codecs.py``).

A payload is a NamedTuple of tensors (packed uint8 codes plus bf16 scale
factors) or, for IDENTITY/WARMUP and ``simulate`` mode, the dense tensor.
All quantization math runs in fp32; every payload field is rounded to its
wire dtype before any consumer reads it.  Each packed codec has a ``sim_*``
twin (compress -> decompress without packing) for ``simulate`` mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from compactfusion_tpu_torch.compact.lowrank import subspace_iter
from compactfusion_tpu_torch.compact.packing import (
    pack_2bit,
    pack_4bit,
    pack_bits,
    unpack_2bit,
    unpack_4bit,
    unpack_bits,
)
from compactfusion_tpu_torch.config import CompressType

SCALE_DTYPE = torch.bfloat16
_EPS = 1e-6


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Round a payload field to the wire dtype, in a contiguous buffer (a QR
    factor arrives column-major; a sent buffer and the quant kernels' scale
    operands are row-major).  Eager PyTorch performs the rounding (the JAX
    package needs an optimization barrier so XLA does not elide the
    f32->bf16->f32 pair)."""
    return x.to(SCALE_DTYPE, memory_format=torch.contiguous_format)


class BinaryPayload(NamedTuple):
    """1-bit signs packed along C + rank-k scale factors U (N,k), V (k,C)."""

    packed: torch.Tensor  # (N, C//8) uint8
    scale_u: torch.Tensor  # (N, k) bf16
    scale_v: torch.Tensor  # (k, C) bf16


class Int2Payload(NamedTuple):
    """2-bit sign+magnitude codes + mean-based scale factors."""

    packed: torch.Tensor  # (N, C//4) uint8
    scale_u: torch.Tensor  # (N, 1) bf16
    scale_v: torch.Tensor  # (1, C) bf16


class MinMaxPayload(NamedTuple):
    """Affine codes (2- or 4-bit packed) + per-channel scale/min."""

    packed: torch.Tensor  # (N, C//4) or (N, C//2) uint8
    scale: torch.Tensor  # (1, C) bf16
    minv: torch.Tensor  # (1, C) bf16


class Int8Payload(NamedTuple):
    q: torch.Tensor  # (N, C) uint8 codes
    scale: torch.Tensor  # (1, C) bf16
    minv: torch.Tensor  # (1, C) bf16


class LowRankPayload(NamedTuple):
    u: torch.Tensor  # (N, k) bf16
    v: torch.Tensor  # (k, C) bf16


class LowRankQPayload(NamedTuple):
    u: MinMaxPayload  # int4-quantized U (N, k)
    v: MinMaxPayload  # int4-quantized V^T (C, k)


class SparsePayload(NamedTuple):
    """1:M structured sparsity: one surviving value per group of M channels."""

    values: torch.Tensor  # (N, C//m) bf16
    indices: torch.Tensor  # (N, C//m) uint8, index within the group


def payload_nbytes(payload) -> int:
    """Bytes on the wire for a payload (a tensor or a tree of them)."""
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    return sum(payload_nbytes(p) for p in payload)


# -- shared scale models ------------------------------------------------------


def _mean_scale_uv(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-based rank-1 scale: U = normalized per-token mean, V = channel mean."""
    a = x32.abs()
    chan = a.mean(dim=0, keepdim=True)  # (1, C)
    tok = a.mean(dim=1, keepdim=True)  # (N, 1)
    tok = tok / (tok.mean() + _EPS)
    return tok, chan


def _scale_uv(x32: torch.Tensor, rank: int, init_q: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if rank == -1:
        return _mean_scale_uv(x32)
    u, v, _ = subspace_iter(x32.abs(), rank, num_iters=2, init_q=init_q)
    return u, v


# -- BINARY: 1-bit signs with a rank-k scale ----------------------------------


def encode_binary(x: torch.Tensor, rank: int = -1) -> BinaryPayload:
    x32 = x.float()
    u, v = _scale_uv(x32, rank)
    return BinaryPayload(pack_bits(x32 >= 0), _wire(u), _wire(v))


def decode_binary(p: BinaryPayload, dtype=torch.float32) -> torch.Tensor:
    sign = unpack_bits(p.packed).float() * 2.0 - 1.0
    scale = p.scale_u.float() @ p.scale_v.float()
    return (sign * scale).to(dtype)


def sim_binary(x: torch.Tensor, rank: int = -1) -> torch.Tensor:
    x32 = x.float()
    u, v = _scale_uv(x32, rank)
    scale = _wire(u).float() @ _wire(v).float()
    return (torch.where(x32 >= 0, 1.0, -1.0) * scale).to(x.dtype)


# -- INT2: sign + magnitude, levels +-0.5s / +-2s, mean scale -----------------
# code = 2*(x >= 0) + (|x| beyond s): x < -s -> -2s, -s <= x < 0 -> -0.5s,
# 0 <= x <= s -> +0.5s, x > s -> +2s.


def _int2_codes(x32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    pos = x32 >= 0
    mag = torch.where(pos, x32 > s, x32 < -s)
    return 2 * pos.to(torch.uint8) + mag.to(torch.uint8)


def _int2_values(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    sign = torch.where(codes >= 2, 1.0, -1.0)
    mag = torch.where((codes & 1).bool(), 2.0, 0.5)
    return sign * mag * s


def encode_int2(x: torch.Tensor) -> Int2Payload:
    x32 = x.float()
    u, v = _mean_scale_uv(x32)
    return Int2Payload(pack_2bit(_int2_codes(x32, u * v)), _wire(u), _wire(v))


def decode_int2(p: Int2Payload, dtype=torch.float32) -> torch.Tensor:
    s = p.scale_u.float() @ p.scale_v.float()
    return _int2_values(unpack_2bit(p.packed), s).to(dtype)


def sim_int2(x: torch.Tensor) -> torch.Tensor:
    """Codes threshold on the fp32 scale, like :func:`encode_int2`; the
    values use the wire-rounded one, like :func:`decode_int2`."""
    x32 = x.float()
    u, v = _mean_scale_uv(x32)
    s_wire = _wire(u).float() * _wire(v).float()
    return _int2_values(_int2_codes(x32, u * v), s_wire).to(x.dtype)


# -- INT2_MINMAX / INT4 / INT8: per-channel affine ----------------------------


def _minmax_scale(x32: torch.Tensor, qmax: int, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    mn, mx = torch.aminmax(x32, dim=axis, keepdim=True)
    # eps on the RANGE, not the denominator: a constant channel (the
    # all-zeros initial cache among them) gets a floored scale, codes 0 and
    # an exact decode to mn, never a division by 0
    return (mx - mn + _EPS) / qmax, mn


def _affine_encode(x32: torch.Tensor, qmax: int, axis: int):
    scale, mn = _minmax_scale(x32, qmax, axis)
    codes = torch.round((x32 - mn) / scale).clamp(0, qmax).to(torch.uint8)
    return codes, scale, mn


def _affine_decode(codes: torch.Tensor, scale: torch.Tensor, minv: torch.Tensor, dtype):
    return (codes.float() * scale.float() + minv.float()).to(dtype)


def encode_int2_minmax(x: torch.Tensor) -> MinMaxPayload:
    codes, scale, mn = _affine_encode(x.float(), 3, axis=0)
    return MinMaxPayload(pack_2bit(codes), _wire(scale), _wire(mn))


def decode_int2_minmax(p: MinMaxPayload, dtype=torch.float32) -> torch.Tensor:
    return _affine_decode(unpack_2bit(p.packed), p.scale, p.minv, dtype)


def sim_int2_minmax(x: torch.Tensor) -> torch.Tensor:
    codes, scale, mn = _affine_encode(x.float(), 3, axis=0)
    return _affine_decode(codes, _wire(scale), _wire(mn), x.dtype)


def encode_int4(x: torch.Tensor, axis: int = 0) -> MinMaxPayload:
    codes, scale, mn = _affine_encode(x.float(), 15, axis=axis)
    return MinMaxPayload(pack_4bit(codes), _wire(scale), _wire(mn))


def decode_int4(p: MinMaxPayload, dtype=torch.float32) -> torch.Tensor:
    return _affine_decode(unpack_4bit(p.packed), p.scale, p.minv, dtype)


def sim_int4(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    codes, scale, mn = _affine_encode(x.float(), 15, axis=axis)
    return _affine_decode(codes, _wire(scale), _wire(mn), x.dtype)


def encode_int8(x: torch.Tensor) -> Int8Payload:
    """Per-channel 8-bit min-max codes (the INT8 codec and the quantized EF
    cache).  Stores the channel minimum, not a zero point, as the JAX
    package does: constant channels decode exactly."""
    codes, scale, mn = _affine_encode(x.float(), 255, axis=0)
    return Int8Payload(codes, _wire(scale), _wire(mn))


def decode_int8(p: Int8Payload, dtype=torch.float32) -> torch.Tensor:
    return _affine_decode(p.q, p.scale, p.minv, dtype)


# -- LOW_RANK / LOW_RANK_AWL / LOW_RANK_Q -------------------------------------


def encode_low_rank(x: torch.Tensor, rank: int) -> LowRankPayload:
    u, v, _ = subspace_iter(x.float(), rank, num_iters=2)
    return LowRankPayload(_wire(u), _wire(v))


def decode_low_rank(p: LowRankPayload, dtype=torch.float32) -> torch.Tensor:
    return (p.u.float() @ p.v.float()).to(dtype)


def sim_low_rank(x: torch.Tensor, rank: int) -> torch.Tensor:
    return decode_low_rank(encode_low_rank(x, rank), x.dtype)


def awl_row_scale(v_nc: torch.Tensor) -> torch.Tensor:
    """V-norm key-importance weights for attention-aware low rank (AWL):
    ``mean(||v_row||) / ||v_row||`` per token of the local, uncompressed V
    (N, C) of the rank whose K is compressed."""
    norm = torch.linalg.vector_norm(v_nc.float(), dim=-1)
    return norm.mean() / (norm + _EPS)


def encode_low_rank_awl(x: torch.Tensor, rank: int,
                        row_scale: Optional[torch.Tensor] = None) -> LowRankPayload:
    """Fit ``diag(s) @ x`` and unscale U afterwards, so important rows
    dominate the subspace.  Wire-identical to LOW_RANK."""
    if row_scale is None:
        return encode_low_rank(x, rank)
    s = row_scale.float()[:, None]
    u, v, _ = subspace_iter(x.float() * s, rank, num_iters=2)
    return LowRankPayload(_wire(u / s), _wire(v))


def sim_low_rank_awl(x: torch.Tensor, rank: int,
                     row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return decode_low_rank(encode_low_rank_awl(x, rank, row_scale), x.dtype)


def encode_low_rank_q(x: torch.Tensor, rank: int) -> LowRankQPayload:
    u, v, _ = subspace_iter(x.float(), rank, num_iters=2)
    return LowRankQPayload(encode_int4(u, axis=0), encode_int4(v.T, axis=0))


def decode_low_rank_q(p: LowRankQPayload, dtype=torch.float32) -> torch.Tensor:
    return (decode_int4(p.u) @ decode_int4(p.v).T).to(dtype)


def sim_low_rank_q(x: torch.Tensor, rank: int) -> torch.Tensor:
    u, v, _ = subspace_iter(x.float(), rank, num_iters=2)
    return (sim_int4(u, axis=0) @ sim_int4(v, axis=1)).to(x.dtype)


# -- SPARSE: 1:M structured sparsity ------------------------------------------


def encode_sparse(x: torch.Tensor, m: int) -> SparsePayload:
    n, c = x.shape
    if c % m:
        raise ValueError(f"C={c} must be divisible by the sparse ratio {m}")
    x32 = x.float().reshape(n, c // m, m)
    idx = x32.abs().argmax(dim=-1, keepdim=True)  # ties go to the first index
    vals = torch.take_along_dim(x32, idx, dim=-1)[..., 0]
    return SparsePayload(_wire(vals), idx[..., 0].to(torch.uint8))


def decode_sparse(p: SparsePayload, m: int, dtype=torch.float32) -> torch.Tensor:
    n, g = p.values.shape
    onehot = torch.nn.functional.one_hot(p.indices.long(), m).float()
    return (onehot * p.values.float()[..., None]).reshape(n, g * m).to(dtype)


def sim_sparse(x: torch.Tensor, m: int) -> torch.Tensor:
    return decode_sparse(encode_sparse(x, m), m, dtype=x.dtype)


# -- dispatch -------------------------------------------------------------------


def encode(x: torch.Tensor, method: CompressType, *, rank: int = -1, sparse_ratio: int = 8,
           awl_scale: Optional[torch.Tensor] = None):
    """Compress an (N, C) tensor (IDENTITY/WARMUP pass it through)."""
    if method in (CompressType.IDENTITY, CompressType.WARMUP):
        return x
    if method == CompressType.BINARY:
        return encode_binary(x, rank)
    if method == CompressType.INT2:
        return encode_int2(x)
    if method == CompressType.INT2_MINMAX:
        return encode_int2_minmax(x)
    if method == CompressType.INT4:
        return encode_int4(x, axis=0)
    if method == CompressType.INT8:
        return encode_int8(x)
    if method == CompressType.LOW_RANK:
        return encode_low_rank(x, rank)
    if method == CompressType.LOW_RANK_AWL:
        return encode_low_rank_awl(x, rank, awl_scale)
    if method == CompressType.LOW_RANK_Q:
        return encode_low_rank_q(x, rank)
    if method == CompressType.SPARSE:
        return encode_sparse(x, sparse_ratio)
    raise ValueError(f"unsupported compress type {method}")


def decode(payload, method: CompressType, *, dtype=torch.float32, sparse_ratio: int = 8) -> torch.Tensor:
    """Inverse of :func:`encode`."""
    if method in (CompressType.IDENTITY, CompressType.WARMUP):
        return payload.to(dtype)
    if method == CompressType.BINARY:
        return decode_binary(payload, dtype)
    if method == CompressType.INT2:
        return decode_int2(payload, dtype)
    if method == CompressType.INT2_MINMAX:
        return decode_int2_minmax(payload, dtype)
    if method == CompressType.INT4:
        return decode_int4(payload, dtype)
    if method == CompressType.INT8:
        return decode_int8(payload, dtype)
    if method in (CompressType.LOW_RANK, CompressType.LOW_RANK_AWL):
        return decode_low_rank(payload, dtype)
    if method == CompressType.LOW_RANK_Q:
        return decode_low_rank_q(payload, dtype)
    if method == CompressType.SPARSE:
        return decode_sparse(payload, sparse_ratio, dtype)
    raise ValueError(f"unsupported compress type {method}")


def sim_roundtrip(x: torch.Tensor, method: CompressType, *, rank: int = -1, sparse_ratio: int = 8,
                  awl_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compress -> decompress locally without packing (``simulate`` mode)."""
    if method in (CompressType.IDENTITY, CompressType.WARMUP):
        return x
    if method == CompressType.BINARY:
        return sim_binary(x, rank)
    if method == CompressType.INT2:
        return sim_int2(x)
    if method == CompressType.INT2_MINMAX:
        return sim_int2_minmax(x)
    if method == CompressType.INT4:
        return sim_int4(x, axis=0)
    if method == CompressType.INT8:
        return decode_int8(encode_int8(x), x.dtype)
    if method == CompressType.LOW_RANK:
        return sim_low_rank(x, rank)
    if method == CompressType.LOW_RANK_AWL:
        return sim_low_rank_awl(x, rank, awl_scale)
    if method == CompressType.LOW_RANK_Q:
        return sim_low_rank_q(x, rank)
    if method == CompressType.SPARSE:
        return sim_sparse(x, sparse_ratio)
    raise ValueError(f"unsupported compress type {method}")
