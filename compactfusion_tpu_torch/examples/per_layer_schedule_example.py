"""Per-layer compression schedule example (counterpart of
``examples/per_layer_schedule_example.py``).

The reference takes a ``compress_func(layer, step)`` consulted per
transformer layer per denoise step (``xfuser/compact/utils.py:51``); here it
resolves into a static plan per (step, layer) before the run.  The plan
below is a common CompactFusion recipe: the first (most
condition-sensitive) layers stay lossless while the rest of the stack runs
1-bit residuals with error feedback, and every layer exchanges raw K/V
during the warmup steps.

    python -m compactfusion_tpu_torch.examples.per_layer_schedule_example \\
        --model PixArt-alpha/PixArt-XL-2-512x512 --num_inference_steps 20
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.per_layer_schedule_example \\
        --model PixArt-alpha/PixArt-XL-2-512x512 --ring_degree 4 --num_inference_steps 20

Works for every compact-capable pipeline (PixArt, FLUX, SD3, CogVideoX,
HunyuanVideo, HunyuanDiT); the two-family models (FLUX's and HunyuanVideo's
double and single stacks, HunyuanDiT's down and up halves) index layers
across both families.  Runs on the GPU (one per rank under ``torchrun``, or
ranks that share one card through ``parallel.mesh.spawn_local``); writes
the final latents of each rank under ``results/``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
from compactfusion_tpu_torch.config import CompressType
from compactfusion_tpu_torch.parallel_api import xDiTParallel
from compactfusion_tpu_torch.utils.prof import Profiler

WARMUP_STEPS = 2
LOSSLESS_LAYERS = 2  # keep the first N layers uncompressed


def compress_func(layer: int, step: int) -> CompressType:
    if step < WARMUP_STEPS:
        return CompressType.WARMUP
    if layer < LOSSLESS_LAYERS:
        return CompressType.IDENTITY
    return CompressType.BINARY


def main(argv=None, check_consistency: bool = False):
    """Parse ``argv`` (default: the command line), build the runner with
    the per-layer plan, warm up, generate, save; returns (the final
    latents, the saved paths).  ``check_consistency`` turns on the EF
    caches' cross-rank check (``CompactConfig.check_consistency``)."""
    parser = FlexibleArgumentParser(description="per-layer schedule example")
    xFuserArgs.add_cli_args(parser)
    args = xFuserArgs.from_cli_args(parser.parse_args(argv))
    args.compact = True
    engine_config, input_config = args.create_config()
    engine_config = dataclasses.replace(
        engine_config,
        compact_config=dataclasses.replace(
            engine_config.compact_config,
            enabled=True,
            compress_type=CompressType.BINARY,
            warmup_steps=WARMUP_STEPS,
            residual=1,
            error_feedback=True,
            compress_func=compress_func,
            check_consistency=check_consistency,
        ),
    )

    runner = xDiTParallel(engine_config, input_config)
    Profiler.enable()
    with Profiler.scope("total"):
        with Profiler.scope("warmup"):
            runner(decode=False)
        with Profiler.scope("generate"):
            out = runner(decode=False)
    arr = out.float().cpu().numpy()
    print(f"latents: shape={arr.shape} finite={np.isfinite(arr).all()}")
    saved = runner.save("results", prefix="per_layer", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
