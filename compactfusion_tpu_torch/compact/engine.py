"""Residual / error-feedback compression engine
(counterpart of ``compactfusion_tpu/compact/engine.py``).

delta = x - base; payload = quantize(delta); the receiver reconstructs
base + dequant(payload); with error feedback sender and receiver both set
base <- that reconstruction, so their caches stay bit-identical.  The state
is an explicit :class:`EFState` the caller threads through; these functions
return new tensors and never write into the state they are given.

With ``quantized_cache`` the state's entries are :class:`codecs.Int8Payload`
(per-channel int8): both sides dequantize to fp32 on entry and requantize
on exit, so their caches stay identical.  The fused CUDA kernels
(``ops/quant.py``) take over residual-1 + error feedback + BINARY or INT2 on
CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from compactfusion_tpu_torch.compact import codecs
from compactfusion_tpu_torch.config import CompactConfig, CompressType


class EFState(NamedTuple):
    """Per-tensor compression state (the reference's base / delta_base pair)."""

    base: torch.Tensor  # (N, C), or an Int8Payload with quantized caches
    delta_base: Optional[torch.Tensor]  # like base when residual == 2, else None


def init_ef_state(shape: Tuple[int, int], dtype=torch.bfloat16, residual: int = 2,
                  quantized: bool = False, device=None) -> EFState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    if quantized:
        # both entries quantize, so the state keeps one structure and dtype
        return EFState(base=codecs.encode_int8(z),
                       delta_base=codecs.encode_int8(z) if residual == 2 else None)
    return EFState(base=z, delta_base=z.clone() if residual == 2 else None)


def _dequant_state(state: EFState) -> EFState:
    return EFState(*(None if e is None else codecs.decode_int8(e, torch.float32) for e in state))


def _requant_state(state: EFState) -> EFState:
    return EFState(*(None if e is None else codecs.encode_int8(e) for e in state))


def _use_fastpath(cfg: CompactConfig, method: CompressType, on_cuda: bool) -> bool:
    """The fused-kernel gate: residual 1 + error feedback + no simulate +
    BINARY or INT2, on a CUDA tensor (the JAX gate asks for the TPU backend)."""
    if not cfg.fastpath or cfg.simulate:
        return False
    if cfg.residual != 1 or not cfg.error_feedback:
        return False
    if method not in (CompressType.BINARY, CompressType.INT2):
        return False
    return on_cuda


def _fastpath_compress(x, state: EFState, cfg: CompactConfig, method: CompressType, update_cache):
    from compactfusion_tpu_torch.ops import quant

    delta32 = x.float() - state.base.float()
    if method == CompressType.BINARY:
        u, v = codecs._scale_uv(delta32, cfg.comp_rank)
        quant_fn, payload_cls = quant.binary_quant_fastpath, codecs.BinaryPayload
    else:  # INT2 always takes the mean scale, whatever comp_rank is
        u, v = codecs._mean_scale_uv(delta32)
        quant_fn, payload_cls = quant.int2_quant_fastpath, codecs.Int2Payload
    u, v = codecs._wire(u), codecs._wire(v)
    packed, new_base = quant_fn(x.contiguous(), state.base, u, v)
    if update_cache:
        state = EFState(base=new_base, delta_base=state.delta_base)
    return payload_cls(packed, u, v), state


def _fastpath_decompress(payload, state: EFState, method: CompressType, update_cache):
    from compactfusion_tpu_torch.ops import quant

    dequant = quant.binary_dequant_fastpath if method == CompressType.BINARY else quant.int2_dequant_fastpath
    x_hat = dequant(payload.packed, state.base, payload.scale_u, payload.scale_v)
    if update_cache:
        state = EFState(base=x_hat, delta_base=state.delta_base)
    return x_hat, state


def _encode(x, cfg: CompactConfig, method: CompressType, awl_scale=None):
    kw = dict(rank=cfg.comp_rank, sparse_ratio=cfg.sparse_ratio, awl_scale=awl_scale)
    if cfg.simulate:
        # simulate mode sends the dense round-tripped tensor
        return codecs.sim_roundtrip(x, method, **kw)
    return codecs.encode(x, method, **kw)


def _decode(payload, cfg: CompactConfig, method: CompressType, dtype):
    if cfg.simulate:
        return payload.to(dtype)
    return codecs.decode(payload, method, dtype=dtype, sparse_ratio=cfg.sparse_ratio)


def _decay(delta_base: torch.Tensor, cfg: CompactConfig) -> torch.Tensor:
    """delta_base * decay with the factor rounded to the state's dtype first,
    as the JAX package multiplies: a Python float would enter a bf16 product
    unrounded.  A 0-dim CPU factor takes part in a CUDA product as a scalar,
    with no copy to the device."""
    return delta_base * torch.tensor(cfg.delta_decay_factor, dtype=delta_base.dtype)


def ef_compress(x: torch.Tensor, state: EFState, cfg: CompactConfig, method: CompressType,
                update_cache: bool = True, awl_scale: Optional[torch.Tensor] = None):
    """Sender side: compress ``x`` against ``state`` -> (payload, new_state).

    For WARMUP/IDENTITY the payload is the raw tensor.  ``awl_scale``: (N,)
    row weights for LOW_RANK_AWL (sender only; the receiver needs none)."""
    if cfg.quantized_cache:
        payload, new = _ef_compress_raw(x, _dequant_state(state), cfg, method, update_cache,
                                        awl_scale)
        return payload, (_requant_state(new) if update_cache else state)
    return _ef_compress_raw(x, state, cfg, method, update_cache, awl_scale)


def _ef_compress_raw(x, state: EFState, cfg: CompactConfig, method: CompressType,
                     update_cache: bool, awl_scale):
    dtype = state.base.dtype
    x = x.to(dtype)

    if method == CompressType.WARMUP:
        # warmup sends the raw activation and primes the caches
        if update_cache:
            delta_base = x - state.base if cfg.residual == 2 else state.delta_base
            state = EFState(base=x, delta_base=delta_base)
        return x, state

    if method == CompressType.IDENTITY or not cfg.enabled:
        return x, state

    if cfg.residual == 0:
        return _encode(x, cfg, method, awl_scale), state

    if cfg.residual == 1:
        if _use_fastpath(cfg, method, x.is_cuda):
            return _fastpath_compress(x, state, cfg, method, update_cache)
        payload = _encode(x - state.base, cfg, method, awl_scale)
        reconstructed = state.base + _decode(payload, cfg, method, dtype)
        if update_cache:
            new_base = reconstructed if cfg.error_feedback else x
            state = EFState(base=new_base, delta_base=state.delta_base)
        return payload, state

    # residual == 2: second-order delta with decay
    payload = _encode(x - state.base - state.delta_base, cfg, method, awl_scale)
    rdd = _decode(payload, cfg, method, dtype)
    new_base = state.base + state.delta_base + rdd
    if update_cache:
        state = EFState(base=new_base, delta_base=_decay(state.delta_base + rdd, cfg))
    return payload, state


def ef_decompress(payload, state: EFState, cfg: CompactConfig, method: CompressType,
                  update_cache: bool = True):
    """Receiver side -> (x_hat, new_state); new_state equals the sender's
    (the error-feedback consistency invariant)."""
    if cfg.quantized_cache:
        x_hat, new = _ef_decompress_raw(payload, _dequant_state(state), cfg, method, update_cache)
        return x_hat, (_requant_state(new) if update_cache else state)
    return _ef_decompress_raw(payload, state, cfg, method, update_cache)


def _ef_decompress_raw(payload, state: EFState, cfg: CompactConfig, method: CompressType,
                       update_cache: bool):
    dtype = state.base.dtype

    if method == CompressType.WARMUP:
        x = payload.to(dtype)
        if update_cache:
            delta_base = x - state.base if cfg.residual == 2 else state.delta_base
            state = EFState(base=x, delta_base=delta_base)
        return x, state

    if method == CompressType.IDENTITY or not cfg.enabled:
        return payload.to(dtype), state

    if cfg.residual == 0:
        return _decode(payload, cfg, method, dtype), state

    if cfg.residual == 1:
        if _use_fastpath(cfg, method, state.base.is_cuda):
            return _fastpath_decompress(payload, state, method, update_cache)
        reconstructed = state.base + _decode(payload, cfg, method, dtype)
        if update_cache:
            state = EFState(base=reconstructed, delta_base=state.delta_base)
        return reconstructed, state

    rdd = _decode(payload, cfg, method, dtype)
    reconstructed = state.base + state.delta_base + rdd
    if update_cache:
        state = EFState(base=reconstructed, delta_base=_decay(state.delta_base + rdd, cfg))
    return reconstructed, state


#: odd 64-bit multipliers (as signed int64) of :func:`bits_digest`
_DIGEST_MULTS = (0x9E3779B97F4A7C15 - (1 << 64), 0xC2B2AE3D27D4EB4F - (1 << 64))


def bits_digest(x: torch.Tensor) -> torch.Tensor:
    """Two position-weighted sums (int64, wrapping) of x's bytes taken as
    64-bit words: the first weighs word i by an odd number, so a copy that
    differs in one word always differs in it, and in several words only
    where the weighted differences cancel mod 2^64 in both sums."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 8:
        b = torch.cat([b, b.new_zeros((-b.numel()) % 8)])
    w = b.view(torch.int64)
    i = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
    return torch.stack([(w * (i * _DIGEST_MULTS[0] | 1)).sum(), ((w ^ (i * _DIGEST_MULTS[1])) * (i | 1)).sum()])


def check_consistency(state: EFState, mesh, axis: str) -> torch.Tensor:
    """Distributed invariant oracle (the reference's
    ``CompactCache.check_consistency``): the mean of every cache entry over
    the ``axis`` group of ``mesh`` (an all-reduce), and the largest absolute
    deviation of this rank's copy from it (a 0-dim fp32 tensor).  Every
    rank's copy of every slot must be identical: the deviation is 0 unless
    sender and receiver error feedback diverged.

    The ranks first gather each entry's :func:`bits_digest` (16 bytes an
    entry, where the all-reduce moves the entry): equal on every rank, the
    copies are the same and the deviation is 0 without the all-reduce;
    else it runs as above.  Every rank sees every digest, so all take the
    same branch.  A NaN or an Inf in any entry gives NaN, as ``x - mean``
    does in the JAX oracle: equal copies share their non-finite entries, so
    with equal digests every rank returns NaN; else the all-reduce carries
    it."""
    n = mesh.axis_size(axis)
    entries = [x for entry in state if entry is not None
               for x in (entry if isinstance(entry, codecs.Int8Payload) else (entry,))]
    digests = torch.stack([bits_digest(x) for x in entries])
    if n == 1 or all(torch.equal(d, digests) for d in mesh.all_gather(digests, axis)):
        finite = bool(torch.stack([torch.isfinite(x).all() for x in entries]).all())
        return torch.full((), 0.0 if finite else float("nan"), dtype=torch.float32, device=entries[0].device)
    devs = []
    for x in entries:
        x32 = x.float()
        mean = mesh.all_reduce_sum(x32, axis) / n
        devs.append((x32 - mean).abs().max())
    return torch.stack(devs).max()
