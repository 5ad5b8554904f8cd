"""CogVideoX example (counterpart of ``examples/cogvideox_example.py``).

    python -m compactfusion_tpu_torch.examples.cogvideox_example --model THUDM/CogVideoX-2b \\
        --height 480 --width 720 --num_frames 49 --num_inference_steps 50 --guidance_scale 6 \\
        --max_sequence_length 226 --prompt "a panda playing a guitar in a bamboo forest"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.cogvideox_example \\
        --model THUDM/CogVideoX-2b --ring_degree 2 --height 480 --width 720 --num_frames 49 \\
        --num_inference_steps 50 --max_sequence_length 226 --compact --compact_type binary
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.cogvideox_example \\
        --pipefusion_parallel_degree 2 --max_sequence_length 226 --prompt "a panda playing a guitar"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.cogvideox_example \\
        --tensor_parallel_degree 2 --max_sequence_length 226 --prompt "a panda playing a guitar"
    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.cogvideox_example \\
        --ring_degree 2 --vae_parallel_size 2 --max_sequence_length 226 --prompt "a panda playing a guitar"

The model defaults to THUDM/CogVideoX-2b and the frames to 49.  At 49 x 480
x 720 the video has 13 x 30 x 45 = 17,550 tokens, which ring 2, Ulysses 2
and cfg 2 split and Ulysses 2 x ring 2 does not (17,550 mod 4 = 2: the
config raises); for that layout pick an even latent frame count, e.g.
``--num_frames 5``.  Writes the video (B, T, H, W, 3) in [0, 1] as one
``.npy`` per rank under ``results/``.  PipeFusion runs sync for CogVideoX
(30 blocks, 15 a stage), as in the JAX package; CogVideoX has no VAE-rank
path, so with ``--vae_parallel_size`` the last ranks stay idle and save
nothing.
"""

from __future__ import annotations

import numpy as np

from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
from compactfusion_tpu_torch.parallel_api import xDiTParallel
from compactfusion_tpu_torch.utils.prof import Profiler


def main(argv=None):
    """Parse ``argv`` (default: the command line), warm up, generate, save;
    returns (the video or latents, the saved path), (None, None) on a rank
    that holds none."""
    parser = FlexibleArgumentParser(description="CogVideoX example")
    xFuserArgs.add_cli_args(parser)
    args = xFuserArgs.from_cli_args(parser.parse_args(argv))
    if args.model == xFuserArgs.model:
        args.model = "THUDM/CogVideoX-2b"
    if args.num_frames == 1:
        args.num_frames = 49
    engine_config, input_config = args.create_config()

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
    saved = runner.save("results", prefix="cogvideox", out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved


if __name__ == "__main__":
    main()
