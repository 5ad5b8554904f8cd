"""HunyuanDiT v1.2 example (counterpart of ``examples/hunyuandit_example.py``).

    python -m compactfusion_tpu_torch.examples.hunyuandit_example \\
        --model Tencent-Hunyuan/HunyuanDiT-v1.2 --height 1024 --width 1024 \\
        --num_inference_steps 25 --guidance_scale 5.0 --prompt "a scenic lake"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.hunyuandit_example \\
        --ulysses_degree 2 --guidance_scale 5.0 --prompt "a scenic lake"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.hunyuandit_example \\
        --pipefusion_parallel_degree 2 --guidance_scale 5.0 --prompt "a scenic lake"

The model defaults to HunyuanDiT v1.2.  Add ``--compact --compact_type
binary`` for the compressed ring over both halves of the blocks.
``--pipefusion_parallel_degree`` runs sync PipeFusion with the mirror skip
channel (each stage's down skips go to its mirror stage).  Writes one PNG
per image and rank under ``results/``; without a checkpoint the weights
are seeded random ones.
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
    parser = FlexibleArgumentParser(description="hunyuandit example")
    xFuserArgs.add_cli_args(parser)
    ns = parser.parse_args(argv)
    if ns.model == xFuserArgs.model:  # the default name: HunyuanDiT v1.2
        ns.model = "Tencent-Hunyuan/HunyuanDiT-v1.2-Diffusers"
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
    saved = runner.save("results", prefix="hunyuandit", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
