"""SD3-medium example (counterpart of ``examples/sd3_example.py``).

    python -m compactfusion_tpu_torch.examples.sd3_example \\
        --model stabilityai/stable-diffusion-3-medium --height 1024 --width 1024 \\
        --num_inference_steps 28 --guidance_scale 7.0 --prompt "a photo of a cat"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.sd3_example \\
        --ulysses_degree 2 --ring_degree 2 --use_cfg_parallel --guidance_scale 7.0 --prompt "a photo of a cat"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.sd3_example \\
        --pipefusion_parallel_degree 2 --guidance_scale 7.0 --prompt "a photo of a cat"

The model defaults to SD3-medium.  Add ``--compact --compact_type binary``
for CompactFusion's compressed ring (the text rides the ring as its joint
rows; only image K/V is compressed), ``--enable_tiling`` /
``--enable_slicing`` for the VAE's tiled or per-image decode.  PipeFusion
runs sync, as in the JAX package's builder (the patch pipeline is
``pipelines/sd3_patch_pp.py``, taken with ``num_pipeline_patch`` > 1).
Unlike the JAX example, which saves the latents, this one decodes and
writes one PNG per image and rank under ``results/``; without a checkpoint
the weights are seeded random ones, so the machinery and its speed are
real and the pixels are not art.
"""

from __future__ import annotations

import numpy as np

from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
from compactfusion_tpu_torch.parallel_api import xDiTParallel
from compactfusion_tpu_torch.utils.prof import Profiler


def main(argv=None):
    """Parse ``argv`` (default: the command line), warm up, generate, save;
    returns (the images, the saved paths), (None, None) on a rank that holds
    none."""
    parser = FlexibleArgumentParser(description="SD3 example")
    xFuserArgs.add_cli_args(parser)
    ns = parser.parse_args(argv)
    if ns.model == xFuserArgs.model:  # the default name: SD3-medium
        ns.model = "stabilityai/stable-diffusion-3-medium"
    engine_config, input_config = xFuserArgs.from_cli_args(ns).create_config()

    runner = xDiTParallel(engine_config, input_config)
    with Profiler.scope("total"):
        with Profiler.scope("warmup"):
            runner()
        with Profiler.scope("generate"):
            out = runner()
    if out is None:  # a VAE rank, or another rank than 0 with VAE ranks
        print("output: none on this rank")
        return out, None
    arr = out.float().cpu().numpy()
    print(f"output: shape={arr.shape} finite={np.isfinite(arr).all()}")
    saved = runner.save("results", prefix="sd3", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
