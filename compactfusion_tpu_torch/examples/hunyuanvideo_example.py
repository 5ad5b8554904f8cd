"""HunyuanVideo-T2V example (counterpart of ``examples/hunyuanvideo_example.py``).

    python -m compactfusion_tpu_torch.examples.hunyuanvideo_example --model tencent/HunyuanVideo \\
        --height 544 --width 960 --num_frames 33 --num_inference_steps 50 --guidance_scale 6 \\
        --max_sequence_length 256 --prompt "a cat walking on grass"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.hunyuanvideo_example --ulysses_degree 2 \\
        --height 544 --width 960 --num_frames 33 --max_sequence_length 256 --prompt "a cat walking on grass"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.hunyuanvideo_example --ring_degree 2 \\
        --height 544 --width 960 --num_frames 33 --compact --compact_type binary --prompt "..."

The model defaults to tencent/HunyuanVideo (20 double + 40 single blocks,
24 heads of 128), the size to the published 129 x 720 x 1280.  Embedded
guidance, no CFG batch.  Writes the video (B, T, H, W, 3) in [0, 1] as one
``.npy`` per rank under ``results/``; ``--enable_tiling`` decodes in
spatial tiles.
"""

from __future__ import annotations

from compactfusion_tpu_torch.examples import _video
from compactfusion_tpu_torch.parallel_api import xDiTParallel


def main(argv=None):
    return _video.run(argv, "HunyuanVideo example", "tencent/HunyuanVideo", "hunyuanvideo", xDiTParallel,
                      num_frames=129, height=720, width=1280)


if __name__ == "__main__":
    main()
