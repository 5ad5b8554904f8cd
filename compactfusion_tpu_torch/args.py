"""CLI argument surface (counterpart of ``compactfusion_tpu/args.py``).

Reference: ``xfuser/config/args.py`` — ``FlexibleArgumentParser`` (accepts
``--key=value`` and underscore/dash spellings) and ``xFuserArgs`` with
``add_cli_args`` / ``from_cli_args`` / ``create_config``.  The flags are the
JAX package's, one for one, and build the same config tree; the toggles the
JAX package accepts and ignores (Ray, onediff, CPU offload, torch.compile,
CUDA graphs) are accepted and ignored here too.  The ``--compact_*`` flags
expose the CompactFusion policy (``CompactConfig``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

from compactfusion_tpu_torch.utils.logger import init_logger

from compactfusion_tpu_torch.config import (
    CompactConfig,
    CompressType,
    EngineConfig,
    FastAttnConfig,
    InputConfig,
    ModelConfig,
    ParallelConfig,
    RuntimeConfig,
)

logger = init_logger(__name__)


class FlexibleArgumentParser(argparse.ArgumentParser):
    """Accepts ``--key=value`` and both ``-``/``_`` spellings
    (reference ``config/args.py:28-48``)."""

    def parse_args(self, args=None, namespace=None):
        if args is None:
            import sys

            args = sys.argv[1:]
        processed = []
        for arg in args:
            if arg.startswith("--"):
                if "=" in arg:
                    key, value = arg.split("=", 1)
                    processed.append("--" + key[2:].replace("-", "_"))
                    processed.append(value)
                else:
                    processed.append("--" + arg[2:].replace("-", "_"))
            else:
                processed.append(arg)
        return super().parse_args(processed, namespace)


@dataclasses.dataclass
class xFuserArgs:
    # model
    model: str = "PixArt-alpha/PixArt-XL-2-512x512"
    # runtime
    warmup_steps: int = 1
    use_parallel_vae: bool = False
    use_profiler: bool = False
    use_torch_compile: bool = False
    use_teacache: bool = False
    use_fbcache: bool = False
    use_cuda_graph: bool = False  # accepted for parity; no graph is captured
    enable_tiling: bool = False  # VAE tiled decode (memory knob)
    enable_slicing: bool = False  # VAE per-sample decode (memory knob)
    # accepted for CLI parity and ignored, as in the JAX package (reference
    # args.py:179-320): Ray placement, onediff, CPU offload
    use_ray: bool = False
    ray_world_size: int = 1
    dit_parallel_size: int = 0
    use_onediff: bool = False
    #: reference flag name; as in the JAX package BOTH flags mean int8
    #: weight quantization of the T5 encoder (text_encoders.quantize_t5_int8)
    use_fp8_t5_encoder: bool = False
    use_int8_t5_encoder: bool = False
    #: int8 weight-quantize the DiT block stacks (cm.quantize_params_int8;
    #: the block's matmuls read the weight dequantized to the activation dtype)
    quantize_backbone_int8: bool = False
    enable_model_cpu_offload: bool = False
    enable_sequential_cpu_offload: bool = False
    # parallel
    data_parallel_degree: int = 1
    use_cfg_parallel: bool = False
    ulysses_degree: int = 1
    ring_degree: int = 1
    use_fused_ring: bool = False
    pipefusion_parallel_degree: int = 1
    num_pipeline_patch: Optional[int] = None
    attn_layer_num_for_pp: Optional[List[int]] = None
    tensor_parallel_degree: int = 1
    vae_parallel_size: int = 0
    split_scheme: str = "row"
    # input
    height: int = 512
    width: int = 512
    num_frames: int = 1
    prompt: Tuple[str, ...] = ("",)
    negative_prompt: Tuple[str, ...] = ("",)
    num_inference_steps: int = 20
    max_sequence_length: int = 120
    guidance_scale: float = 4.5
    seed: int = 42
    output_type: str = "pil"
    no_use_resolution_binning: bool = False
    img_file_path: Optional[str] = None
    # fast attn
    use_fast_attn: bool = False
    n_calib: int = 8
    threshold: float = 0.5
    window_size: int = 64
    coco_path: Optional[str] = None
    use_cache: bool = False
    # compact (the compression policy on the CLI)
    compact: bool = False
    compact_type: str = "binary"
    compact_warmup_steps: int = 4
    compact_rank: int = -1
    compact_residual: int = 1
    compact_no_ef: bool = False
    compact_patch_gather: bool = False
    compact_patch_async: bool = False

    @staticmethod
    def add_cli_args(parser: FlexibleArgumentParser) -> FlexibleArgumentParser:
        model = parser.add_argument_group("Model Options")
        model.add_argument("--model", type=str, default=xFuserArgs.model)

        run = parser.add_argument_group("Runtime Options")
        run.add_argument("--warmup_steps", type=int, default=1)
        for flag in (
            "use_parallel_vae",
            "use_profiler",
            "use_torch_compile",
            "use_teacache",
            "use_fbcache",
            "use_cuda_graph",
            "enable_tiling",
            "enable_slicing",
            "use_ray",
            "use_onediff",
            "use_fp8_t5_encoder",
            "use_int8_t5_encoder",
            "quantize_backbone_int8",
            "enable_model_cpu_offload",
            "enable_sequential_cpu_offload",
        ):
            run.add_argument(f"--{flag}", action="store_true")
        run.add_argument("--ray_world_size", type=int, default=1)
        run.add_argument("--dit_parallel_size", type=int, default=0)

        par = parser.add_argument_group("Parallel Processing Options")
        par.add_argument("--data_parallel_degree", type=int, default=1)
        par.add_argument("--use_cfg_parallel", action="store_true")
        par.add_argument("--ulysses_degree", type=int, default=1)
        par.add_argument("--ring_degree", type=int, default=1)
        par.add_argument("--use_fused_ring", action="store_true")
        par.add_argument("--pipefusion_parallel_degree", type=int, default=1)
        par.add_argument("--num_pipeline_patch", type=int, default=None)
        par.add_argument(
            "--attn_layer_num_for_pp", type=int, nargs="*", default=None
        )
        par.add_argument("--tensor_parallel_degree", type=int, default=1)
        par.add_argument("--vae_parallel_size", type=int, default=0)
        par.add_argument("--split_scheme", type=str, default="row")

        inp = parser.add_argument_group("Input Options")
        inp.add_argument("--height", type=int, default=512)
        inp.add_argument("--width", type=int, default=512)
        inp.add_argument("--num_frames", type=int, default=1)
        inp.add_argument("--prompt", type=str, nargs="*", default=[""])
        inp.add_argument("--negative_prompt", type=str, nargs="*", default=[""])
        inp.add_argument("--no_use_resolution_binning", action="store_true")
        inp.add_argument("--num_inference_steps", type=int, default=20)
        inp.add_argument("--max_sequence_length", type=int, default=120)
        inp.add_argument("--guidance_scale", type=float, default=4.5)
        inp.add_argument("--seed", type=int, default=42)
        inp.add_argument("--output_type", type=str, default="pil")
        inp.add_argument("--img_file_path", type=str, default=None)

        fa = parser.add_argument_group("DiTFastAttn Options")
        fa.add_argument("--use_fast_attn", action="store_true")
        fa.add_argument("--n_calib", type=int, default=8)
        fa.add_argument("--threshold", type=float, default=0.5)
        fa.add_argument("--window_size", type=int, default=64)
        fa.add_argument("--coco_path", type=str, default=None)
        fa.add_argument("--use_cache", action="store_true")

        cp = parser.add_argument_group("CompactFusion Options")
        cp.add_argument("--compact", action="store_true")
        cp.add_argument(
            "--compact_type",
            type=str,
            default="binary",
            choices=[t.value for t in CompressType],
        )
        cp.add_argument("--compact_warmup_steps", type=int, default=4)
        cp.add_argument("--compact_rank", type=int, default=-1)
        cp.add_argument("--compact_residual", type=int, default=1)
        cp.add_argument("--compact_no_ef", action="store_true")
        cp.add_argument("--compact_patch_gather", action="store_true")
        cp.add_argument("--compact_patch_async", action="store_true")
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "xFuserArgs":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(args).items() if k in fields}
        if "prompt" in kwargs and isinstance(kwargs["prompt"], list):
            kwargs["prompt"] = tuple(kwargs["prompt"])
        if "negative_prompt" in kwargs and isinstance(
            kwargs["negative_prompt"], list
        ):
            kwargs["negative_prompt"] = tuple(kwargs["negative_prompt"])
        return cls(**kwargs)

    def create_config(self) -> Tuple[EngineConfig, InputConfig]:
        """Validate and build the frozen config tree
        (reference ``config/args.py:373-465``)."""
        if self.attn_layer_num_for_pp is not None:
            # the reference supports UNEVEN stage splits
            # (config/config.py:170-176); the SPMD stacked-scan design
            # shards the layer axis evenly — surface the deviation instead
            # of silently using a different split than requested
            logger.warning(
                "--attn_layer_num_for_pp is not supported by the port "
                "(stage-sharded stacks split evenly); ignoring %s",
                self.attn_layer_num_for_pp,
            )
        parallel = ParallelConfig(
            dp_degree=self.data_parallel_degree,
            cfg_degree=2 if self.use_cfg_parallel else 1,
            pp_degree=self.pipefusion_parallel_degree,
            ulysses_degree=self.ulysses_degree,
            ring_degree=self.ring_degree,
            use_fused_ring=self.use_fused_ring,
            tp_degree=self.tensor_parallel_degree,
            vae_parallel_size=self.vae_parallel_size,
            num_pipeline_patch=self.num_pipeline_patch,
        )
        if self.compact:
            compact = CompactConfig(
                enabled=True,
                compress_type=CompressType(self.compact_type),
                warmup_steps=self.compact_warmup_steps,
                comp_rank=self.compact_rank,
                residual=self.compact_residual,
                error_feedback=not self.compact_no_ef,
                patch_gather=self.compact_patch_gather,
                patch_async=self.compact_patch_async,
            )
        else:
            # don't validate compact flag combos for runs that never use
            # compression (e.g. --compact_residual 0 without --compact_no_ef
            # would abort here even with compression disabled)
            compact = CompactConfig()
        engine = EngineConfig(
            model_config=ModelConfig(
                model=self.model, pretrained_model_name_or_path=self.model
            ),
            runtime_config=RuntimeConfig(
                warmup_steps=self.warmup_steps,
                use_parallel_vae=self.use_parallel_vae,
                use_profiler=self.use_profiler,
                use_torch_compile=self.use_torch_compile,
                use_teacache=self.use_teacache,
                use_fbcache=self.use_fbcache,
                use_fast_attn=self.use_fast_attn,
                enable_tiling=self.enable_tiling,
                enable_slicing=self.enable_slicing,
                quantize_t5=self.use_fp8_t5_encoder or self.use_int8_t5_encoder,
                quantize_backbone=self.quantize_backbone_int8,
            ),
            parallel_config=parallel,
            fast_attn_config=FastAttnConfig(
                use_fast_attn=self.use_fast_attn,
                n_calib=self.n_calib,
                threshold=self.threshold,
                window_size=self.window_size,
                coco_path=self.coco_path,
                use_cache=self.use_cache,
            ),
            compact_config=compact,
        )
        inp = InputConfig(
            height=self.height,
            width=self.width,
            num_frames=self.num_frames,
            batch_size=len(self.prompt),
            num_inference_steps=self.num_inference_steps,
            guidance_scale=self.guidance_scale,
            seed=self.seed,
            max_sequence_length=self.max_sequence_length,
            prompt=tuple(self.prompt),
            negative_prompt=tuple(self.negative_prompt),
            img_file_path=self.img_file_path,
            use_resolution_binning=not self.no_use_resolution_binning,
            output_type=self.output_type,
        )
        return engine, inp
