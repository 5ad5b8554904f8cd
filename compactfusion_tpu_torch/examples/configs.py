"""Canned CompactFusion method presets (counterpart of ``examples/configs.py``).

``get_config(model_name, method)`` returns the :class:`CompactConfig` for a
named method, the reference's presets: warmup steps send raw, steady
steps run the chosen codec, residual order 1 with error feedback, fastpath
kernels on.  "df" / "patch" / "int2patch" select the patch-parallel
(DistriFusion) forward instead of the ring; "ring" / "ulysses" / "pipe"
disable compression (those baselines are pure parallelism choices).
"""

from __future__ import annotations

from compactfusion_tpu_torch.config import CompactConfig, CompressType

_WARMUP = {"CogVideoX": 2}  # reference: 2 for CogVideoX, 1 elsewhere


def get_config(model_name: str, method: str) -> CompactConfig:
    warmup = _WARMUP.get(model_name, 1)
    base = dict(
        enabled=True, warmup_steps=warmup, residual=1, error_feedback=True,
        fastpath=True,
    )
    if method == "binary":
        return CompactConfig(compress_type=CompressType.BINARY, comp_rank=-1, **base)
    if method == "int2":
        return CompactConfig(compress_type=CompressType.INT2, **base)
    if method == "lowrank12":
        return CompactConfig(compress_type=CompressType.LOW_RANK, comp_rank=12, **base)
    if method == "lowrank8":
        return CompactConfig(compress_type=CompressType.LOW_RANK, comp_rank=8, **base)
    if method == "lowrank4":
        # the JAX package's >=100x operating point (its rank sweep found
        # rank 4 matching binary's latent error at 7x fewer wire bytes)
        return CompactConfig(compress_type=CompressType.LOW_RANK, comp_rank=4, **base)
    if method == "lowrank2":
        return CompactConfig(compress_type=CompressType.LOW_RANK, comp_rank=2, **base)
    if method == "lowrankawl2":
        return CompactConfig(
            compress_type=CompressType.LOW_RANK_AWL, comp_rank=2, **base
        )
    if method == "lowrankq32":
        return CompactConfig(
            compress_type=CompressType.LOW_RANK_Q, comp_rank=32, **base
        )
    if method == "df":
        # DistriFusion: one-step-stale async patch gather, no codec
        return CompactConfig(
            enabled=True, compress_type=CompressType.IDENTITY,
            warmup_steps=warmup, residual=0, error_feedback=False,
            patch_gather=True, patch_async=True,
        )
    if method == "patch":
        # compressed synchronous patch gather (binary)
        return CompactConfig(
            compress_type=CompressType.BINARY, comp_rank=-1,
            patch_gather=True, **base
        )
    if method == "int2patch":
        return CompactConfig(
            compress_type=CompressType.INT2, patch_gather=True, **base
        )
    if method in ("ring", "ulysses", "pipe"):
        return CompactConfig()  # compression disabled; pure parallelism
    raise ValueError(f"unknown method {method!r}")
