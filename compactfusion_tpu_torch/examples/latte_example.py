"""Latte-1 example (counterpart of ``examples/latte_example.py``).

    python -m compactfusion_tpu_torch.examples.latte_example --model maxin-cn/Latte-1 \\
        --height 512 --width 512 --num_frames 16 --num_inference_steps 50 --guidance_scale 7.5 \\
        --prompt "a cat wearing sunglasses on a beach"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.latte_example --ulysses_degree 2 \\
        --prompt "a cat wearing sunglasses on a beach"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.latte_example --cfg_degree 2 \\
        --prompt "a cat wearing sunglasses on a beach"

The model defaults to maxin-cn/Latte-1 and the frames to 16.  Whole frames
shard over the sequence-parallel ranks (ring x Ulysses must divide the
frames); each temporal block takes two all-to-alls.  Writes the video (B,
T, H, W, 3) in [0, 1] as one ``.npy`` per rank under ``results/``.
"""

from __future__ import annotations

from compactfusion_tpu_torch.examples import _video
from compactfusion_tpu_torch.parallel_api import xDiTParallel


def main(argv=None):
    return _video.run(argv, "Latte example", "maxin-cn/Latte-1", "latte", xDiTParallel, num_frames=16)


if __name__ == "__main__":
    main()
