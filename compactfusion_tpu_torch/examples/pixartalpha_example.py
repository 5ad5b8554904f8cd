"""PixArt-alpha example (counterpart of ``examples/pixartalpha_example.py``).

    python -m compactfusion_tpu_torch.examples.pixartalpha_example \\
        --model PixArt-alpha/PixArt-XL-2-512x512 --height 512 --width 512 \\
        --num_inference_steps 20 --prompt "a small cactus with a happy face"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.pixartalpha_example \\
        --ulysses_degree 2 --ring_degree 2 --prompt "a small cactus with a happy face"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.pixartalpha_example \\
        --pipefusion_parallel_degree 2 --prompt "a small cactus with a happy face"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.pixartalpha_example \\
        --tensor_parallel_degree 2 --prompt "a small cactus with a happy face"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.pixartalpha_example \\
        --ring_degree 2 --vae_parallel_size 2 --prompt "a small cactus with a happy face"

Add ``--compact --compact_type binary`` for CompactFusion's compressed ring
attention.  ``--pipefusion_parallel_degree 2`` runs PipeFusion's patch
pipeline with ``--num_pipeline_patch`` 2 (the default, M = pp) after
``--warmup_steps`` sync steps; ``--num_pipeline_patch 1`` runs it sync.  With
``--vae_parallel_size`` the last ranks decode in height bands and only rank
0 holds (and saves) the image.  Runs on the GPU (one per rank under ``torchrun``); without a
checkpoint the weights are seeded random ones, so the machinery and its
speed are real and the pixels are not art.  Writes one PNG per image and
rank under ``results/``.
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
    parser = FlexibleArgumentParser(description="PixArt-alpha example")
    xFuserArgs.add_cli_args(parser)
    ns = parser.parse_args(argv)
    engine_config, input_config = xFuserArgs.from_cli_args(ns).create_config()

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
    saved = runner.save("results", prefix="pixart_alpha", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
