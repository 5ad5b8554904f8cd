"""Residual / error-feedback compression engine
(counterpart of ``compactfusion_tpu/compact/engine.py``).

delta = x - base; payload = quantize(delta); the receiver reconstructs
base + dequant(payload); with error feedback sender and receiver both set
base <- that reconstruction, so their caches stay bit-identical.  The state
is an explicit :class:`EFState` the caller threads through; these functions
return new tensors and never write into the state they are given.

The fused CUDA kernels (``ops/quant.py``) take over residual-1 + error
feedback + BINARY on CUDA tensors.  Quantized caches, ``simulate`` mode and
the INT2 kernel are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from compactfusion_tpu_torch import ROADMAP_HINT
from compactfusion_tpu_torch.compact import codecs
from compactfusion_tpu_torch.config import CompactConfig, CompressType


class EFState(NamedTuple):
    """Per-tensor compression state (the reference's base / delta_base pair)."""

    base: torch.Tensor  # (N, C)
    delta_base: Optional[torch.Tensor]  # (N, C) when residual == 2, else None


def init_ef_state(shape: Tuple[int, int], dtype=torch.bfloat16, residual: int = 2,
                  quantized: bool = False, device=None) -> EFState:
    if quantized:
        raise NotImplementedError(f"int8-quantized EF caches: {ROADMAP_HINT}")
    z = torch.zeros(shape, dtype=dtype, device=device)
    return EFState(base=z, delta_base=z.clone() if residual == 2 else None)


def _use_fastpath(cfg: CompactConfig, method: CompressType, on_cuda: bool) -> bool:
    """The fused-kernel gate: residual 1 + error feedback + no simulate +
    BINARY, on a CUDA tensor (the JAX gate asks for the TPU backend)."""
    if not cfg.fastpath or cfg.simulate:
        return False
    if cfg.residual != 1 or not cfg.error_feedback:
        return False
    if method not in (CompressType.BINARY, CompressType.INT2):
        return False
    if not on_cuda:
        return False
    if method == CompressType.INT2:
        raise NotImplementedError(f"INT2 fused quant kernel: {ROADMAP_HINT}")
    return True


def _fastpath_compress(x, state: EFState, cfg: CompactConfig, update_cache):
    from compactfusion_tpu_torch.ops.quant import binary_quant_fastpath

    delta32 = x.float() - state.base.float()
    u, v = codecs._scale_uv(delta32, cfg.comp_rank)
    u, v = codecs._wire(u), codecs._wire(v)
    packed, new_base = binary_quant_fastpath(x.contiguous(), state.base, u, v)
    if update_cache:
        state = EFState(base=new_base, delta_base=state.delta_base)
    return codecs.BinaryPayload(packed, u, v), state


def _fastpath_decompress(payload, state: EFState, update_cache):
    from compactfusion_tpu_torch.ops.quant import binary_dequant_fastpath

    x_hat = binary_dequant_fastpath(payload.packed, state.base, payload.scale_u, payload.scale_v)
    if update_cache:
        state = EFState(base=x_hat, delta_base=state.delta_base)
    return x_hat, state


def _check_supported(cfg: CompactConfig) -> None:
    if cfg.quantized_cache:
        raise NotImplementedError(f"quantized_cache: {ROADMAP_HINT}")
    if cfg.simulate:
        raise NotImplementedError(f"simulate mode (sim_roundtrip codecs): {ROADMAP_HINT}")


def ef_compress(x: torch.Tensor, state: EFState, cfg: CompactConfig, method: CompressType,
                update_cache: bool = True):
    """Sender side: compress ``x`` against ``state`` -> (payload, new_state).

    For WARMUP/IDENTITY the payload is the raw tensor."""
    _check_supported(cfg)
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
        return codecs.encode(x, method, rank=cfg.comp_rank), state

    if cfg.residual == 1:
        if _use_fastpath(cfg, method, x.is_cuda):
            return _fastpath_compress(x, state, cfg, update_cache)
        payload = codecs.encode(x - state.base, method, rank=cfg.comp_rank)
        reconstructed = state.base + codecs.decode(payload, method, dtype=dtype)
        if update_cache:
            new_base = reconstructed if cfg.error_feedback else x
            state = EFState(base=new_base, delta_base=state.delta_base)
        return payload, state

    # residual == 2: second-order delta with decay
    payload = codecs.encode(x - state.base - state.delta_base, method, rank=cfg.comp_rank)
    rdd = codecs.decode(payload, method, dtype=dtype)
    new_base = state.base + state.delta_base + rdd
    new_delta_base = (state.delta_base + rdd) * cfg.delta_decay_factor
    if update_cache:
        state = EFState(base=new_base, delta_base=new_delta_base)
    return payload, state


def ef_decompress(payload, state: EFState, cfg: CompactConfig, method: CompressType,
                  update_cache: bool = True):
    """Receiver side -> (x_hat, new_state); new_state equals the sender's
    (the error-feedback consistency invariant)."""
    _check_supported(cfg)
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
        return codecs.decode(payload, method, dtype=dtype), state

    if cfg.residual == 1:
        if _use_fastpath(cfg, method, state.base.is_cuda):
            return _fastpath_decompress(payload, state, update_cache)
        reconstructed = state.base + codecs.decode(payload, method, dtype=dtype)
        if update_cache:
            state = EFState(base=reconstructed, delta_base=state.delta_base)
        return reconstructed, state

    rdd = codecs.decode(payload, method, dtype=dtype)
    reconstructed = state.base + state.delta_base + rdd
    new_delta_base = (state.delta_base + rdd) * cfg.delta_decay_factor
    if update_cache:
        state = EFState(base=reconstructed, delta_base=new_delta_base)
    return reconstructed, state
