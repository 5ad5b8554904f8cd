"""FLUX.1 example (counterpart of ``examples/flux_example.py``).

    python -m compactfusion_tpu_torch.examples.flux_example --model black-forest-labs/FLUX.1-dev \\
        --height 1024 --width 1024 --num_inference_steps 28 --prompt "a photo of a cat"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.flux_example \\
        --model black-forest-labs/FLUX.1-dev --ulysses_degree 2 --ring_degree 2 \\
        --height 1024 --width 1024 --num_inference_steps 28 --compact --compact_type binary
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.flux_example \\
        --model black-forest-labs/FLUX.1-dev --pipefusion_parallel_degree 2 --prompt "a photo of a cat"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.flux_example \\
        --model black-forest-labs/FLUX.1-dev --tensor_parallel_degree 2 --prompt "a photo of a cat"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.flux_example \\
        --model black-forest-labs/FLUX.1-dev --ring_degree 2 --vae_parallel_size 2 --prompt "a photo of a cat"

The compact flags replicate the reference's ``compact_init(CompactConfig(...))``
setup: warmup steps exchange raw K/V, later steps 1-bit residuals with
error feedback.  A guidance scale left at the CLI default 4.5 becomes
FLUX's 3.5.  ``--quantize_backbone_int8`` stores the block stacks in int8.
Unlike the JAX example, which saves the latents, this one decodes and
writes one PNG per image and rank under ``results/``.  PipeFusion runs sync
for FLUX (19 + 38 blocks padded with identity blocks to divide the stages),
as in the JAX package; FLUX has no VAE-rank path, so with
``--vae_parallel_size`` the last ranks stay idle and save nothing.
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
    parser = FlexibleArgumentParser(description="FLUX example")
    xFuserArgs.add_cli_args(parser)
    ns = parser.parse_args(argv)
    args = xFuserArgs.from_cli_args(ns)
    args.guidance_scale = 3.5 if args.guidance_scale == 4.5 else args.guidance_scale
    engine_config, input_config = args.create_config()

    runner = xDiTParallel(engine_config, input_config)
    Profiler.enable()
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
    saved = runner.save("results", prefix="flux", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
