"""PixArt-Sigma example (counterpart of ``examples/pixartsigma_example.py``).

    python -m compactfusion_tpu_torch.examples.pixartsigma_example \\
        --model PixArt-alpha/PixArt-Sigma-XL-2-1024-MS --height 1024 --width 1024 \\
        --num_inference_steps 20 --prompt "a small cactus with a happy face"
    python -m compactfusion_tpu_torch.examples.pixartsigma_example \\
        --model PixArt-alpha/PixArt-Sigma-XL-2-2K-MS --height 2048 --width 2048 \\
        --num_inference_steps 20 --enable_tiling --prompt "a small cactus with a happy face"

A model name with "2k" (or a height above 1024) takes PixArt-Sigma 2K, one
with "sigma" (or a height above 512) PixArt-Sigma 1024; the default name
takes Sigma 1024 at 1024 x 1024 at least.  The request is binned to the
model's native area and the image resized back.  ``--enable_tiling``
decodes the 2K image in overlapping tiles.  Writes one PNG per image and
rank under ``results/``; without a checkpoint the weights are seeded
random ones.
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
    parser = FlexibleArgumentParser(description="PixArt-Sigma example")
    xFuserArgs.add_cli_args(parser)
    ns = parser.parse_args(argv)
    if ns.model == xFuserArgs.model:  # the default name: PixArt-Sigma 1024
        ns.model = "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS"
        ns.height = max(ns.height, 1024)
        ns.width = max(ns.width, 1024)
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
    saved = runner.save("results", prefix="pixart_sigma", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
