"""Frozen configuration dataclasses (counterpart of ``compactfusion_tpu/config.py``).

Same fields and defaults as the JAX package, so a configuration reads the
same in both; ``tests/test_torch_package.py`` checks that they agree.  The
engine tree (``EngineConfig`` and its parts, ``InputConfig``) is what
``args.xFuserArgs.create_config`` builds and ``parallel_api.xDiTParallel``
runs.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional, Tuple


class CompressType(enum.Enum):
    """Compression codec selector (reference ``COMPACT_COMPRESS_TYPE``)."""

    WARMUP = "warmup"
    SPARSE = "sparse"
    BINARY = "binary"
    INT2 = "int2"
    INT2_MINMAX = "int2-minmax"
    INT4 = "int4"
    INT8 = "int8"
    IDENTITY = "identity"
    LOW_RANK = "low-rank"
    LOW_RANK_Q = "low-rank-int4"
    LOW_RANK_AWL = "low-rank-awl"


@dataclasses.dataclass(frozen=True)
class CompactConfig:
    """Residual-compression policy: ``warmup_steps`` raw steps, then
    ``compress_type`` on every layer (see the JAX docstring for each field)."""

    enabled: bool = False
    compress_type: CompressType = CompressType.BINARY
    warmup_steps: int = 4
    #: rank of the scale model (-1 = mean scale)
    comp_rank: int = -1
    #: residual order: 0 = raw, 1 = delta, 2 = delta-of-delta
    residual: int = 1
    error_feedback: bool = True
    simulate: bool = False
    #: single-device ring-topology emulation (``models/attn_impl.SimRingAttn``)
    simulate_ring: int = 0
    sparse_ratio: int = 8
    delta_decay_factor: float = 0.9
    check_consistency: bool = False
    #: use the fused quant kernels where available (CUDA tensors here)
    fastpath: bool = True
    quantized_cache: bool = False
    log_stats: bool = False
    patch_gather: bool = False
    patch_async: bool = False
    compress_func: Optional[Callable[[int, int], "CompressType"]] = None

    def __post_init__(self):
        if self.residual not in (0, 1, 2):
            raise ValueError(f"residual must be 0/1/2, got {self.residual}")
        if self.residual == 0 and self.error_feedback:
            raise ValueError("residual=0 does not support error feedback")
        if self.residual == 2 and not self.error_feedback:
            raise ValueError("residual=2 requires error feedback")
        if self.comp_rank == 0 or self.comp_rank < -1:
            raise ValueError("comp_rank must be >= 1 or -1 (mean scale)")

    def type_at(self, layer: int, step: int) -> CompressType:
        """Static compression schedule (per layer when compress_func set)."""
        if not self.enabled:
            return CompressType.IDENTITY
        if self.compress_func is not None:
            return self.compress_func(layer, step)
        if step < self.warmup_steps:
            return CompressType.WARMUP
        return self.compress_type

    def layer_plan(self, step: int, depth: int) -> Tuple["CompressType", ...]:
        return tuple(self.type_at(l, step) for l in range(depth))


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Degrees of each parallel axis, in the JAX mesh order
    ``(dp, cfg, pp, ring, ulysses, tp)``."""

    dp_degree: int = 1
    cfg_degree: int = 1
    pp_degree: int = 1
    ulysses_degree: int = 1
    ring_degree: int = 1
    tp_degree: int = 1
    vae_parallel_size: int = 0
    num_pipeline_patch: Optional[int] = None
    use_fused_ring: bool = False

    @property
    def sp_degree(self) -> int:
        return self.ulysses_degree * self.ring_degree

    @property
    def world_size(self) -> int:
        return (
            self.dp_degree
            * self.cfg_degree
            * self.pp_degree
            * self.sp_degree
            * self.tp_degree
        )

    def __post_init__(self):
        for name in (
            "dp_degree",
            "cfg_degree",
            "pp_degree",
            "ulysses_degree",
            "ring_degree",
            "tp_degree",
        ):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.cfg_degree not in (1, 2):
            raise ValueError("cfg_degree (classifier-free guidance) must be 1 or 2")


def validate_parallel_geometry(
    parallel: ParallelConfig,
    *,
    heads: int,
    tokens: int,
    depth: Optional[int] = None,
    num_pipeline_patch: int = 1,
    patch_pp_min_factor: int = 1,
    tp_shards_heads: bool = False,
    family: str = "model",
) -> None:
    """Reject degree/geometry factorizations up front with readable errors
    (same rules and messages as the JAX package)."""
    u, r, pp = parallel.ulysses_degree, parallel.ring_degree, parallel.pp_degree
    head_shards = u * (parallel.tp_degree if tp_shards_heads else 1)
    if heads % head_shards != 0:
        detail = (
            f"ulysses_degree ({u}) * tp_degree ({parallel.tp_degree})"
            if tp_shards_heads
            else f"ulysses_degree ({u})"
        )
        raise ValueError(
            f"{family}: attention heads ({heads}) must be divisible by "
            f"{detail} — the Ulysses all-to-all scatters whole heads"
        )
    sp = u * r
    m = max(num_pipeline_patch, 1)
    if pp > 1 and m > 1:
        if tokens % m != 0:
            raise ValueError(
                f"{family}: latent tokens ({tokens}) must be divisible by "
                f"num_pipeline_patch ({m})"
            )
        if (tokens // m) % sp != 0:
            raise ValueError(
                f"{family}: tokens per pipeline patch ({tokens}//{m} = "
                f"{tokens // m}) must be divisible by sp_degree "
                f"(ring {r} x ulysses {u} = {sp})"
            )
        if m < patch_pp_min_factor * pp:
            raise ValueError(
                f"{family}: async patch-PP needs num_pipeline_patch >= "
                f"{patch_pp_min_factor}*pp_degree "
                f"({patch_pp_min_factor}*{pp} = {patch_pp_min_factor * pp}, "
                f"got {m}) to keep the virtual pipeline full"
            )
    elif tokens % sp != 0:
        raise ValueError(
            f"{family}: latent tokens ({tokens}) must be divisible by "
            f"sp_degree (ring {r} x ulysses {u} = {sp}) — pick an image/"
            f"video size whose token count splits evenly"
        )
    if depth is not None and depth % pp != 0:
        raise ValueError(
            f"{family}: transformer depth ({depth}) must split evenly over "
            f"pp_degree ({pp})"
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Which model to run (reference ``ModelConfig``)."""

    model: str = "pixart-alpha"
    pretrained_model_name_or_path: Optional[str] = None
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime toggles (reference ``RuntimeConfig``)."""

    warmup_steps: int = 1
    use_parallel_vae: bool = False
    #: wrap generation in ``utils/prof`` scopes and log the summary
    use_profiler: bool = False
    #: accepted for CLI parity; the port runs eager
    use_torch_compile: bool = False
    use_teacache: bool = False
    use_fbcache: bool = False
    use_fast_attn: bool = False
    #: VAE decode memory knobs: the 2D VAE's tiled and per-image decode
    #: (``parallel_api._vae_opts``); the 3D VAE families set its tiling themselves
    enable_tiling: bool = False
    enable_slicing: bool = False
    #: int8 weight-quantize the T5 text encoder (``--use_int8_t5_encoder``,
    #: ``--use_fp8_t5_encoder``; ``models/text_encoders.quantize_t5_int8``)
    quantize_t5: bool = False
    #: int8 weight-quantize the DiT block stacks (``--quantize_backbone_int8``;
    #: ``models/common.quantize_params_int8``)
    quantize_backbone: bool = False


@dataclasses.dataclass(frozen=True)
class FastAttnConfig:
    """DiTFastAttn calibration settings."""

    use_fast_attn: bool = False
    n_step: int = 20
    n_calib: int = 8
    threshold: float = 0.5
    window_size: int = 64
    coco_path: Optional[str] = None
    use_cache: bool = False


@dataclasses.dataclass(frozen=True)
class InputConfig:
    """Generation request shape (reference ``InputConfig``)."""

    height: int = 512
    width: int = 512
    num_frames: int = 1
    batch_size: int = 1
    num_inference_steps: int = 20
    guidance_scale: float = 4.5
    seed: int = 42
    max_sequence_length: int = 120
    prompt: Tuple[str, ...] = ("",)
    negative_prompt: Tuple[str, ...] = ("",)
    #: identity image of the ConsisID family: a PNG through the face
    #: encoder to its identity tokens (``parallel_api._encode_identity``)
    img_file_path: Optional[str] = None
    #: snap (height, width) to the nearest aspect-ratio bin at the model's
    #: native area and resize the output back (PixArt family)
    use_resolution_binning: bool = True
    #: "pil" decodes to pixels; "latent" returns the raw latents
    output_type: str = "pil"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level config tree (reference ``EngineConfig``)."""

    model_config: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    runtime_config: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    parallel_config: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    fast_attn_config: FastAttnConfig = dataclasses.field(default_factory=FastAttnConfig)
    compact_config: CompactConfig = dataclasses.field(default_factory=CompactConfig)


def resolve_compress_schedule(
    cfg: CompactConfig,
    num_steps: int,
    compress_func: Optional[Callable[[int, int], CompressType]] = None,
) -> Tuple[CompressType, ...]:
    """A (possibly callable) policy as a static per-step schedule, layer 0's."""
    if compress_func is None:
        return tuple(cfg.type_at(0, s) for s in range(num_steps))
    return tuple(compress_func(0, s) for s in range(num_steps))


def validate_against_device_count(parallel: ParallelConfig, n_devices: int) -> None:
    total = parallel.world_size + parallel.vae_parallel_size
    if total > n_devices:
        raise ValueError(
            f"parallel config needs {total} devices "
            f"(dit {parallel.world_size} + vae {parallel.vae_parallel_size}) "
            f"but only {n_devices} are available"
        )
    if n_devices % parallel.world_size != 0 and parallel.vae_parallel_size == 0:
        raise ValueError(
            f"world size {parallel.world_size} does not divide device count {n_devices}"
        )


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
