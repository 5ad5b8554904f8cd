"""Step-Video-T2V example (counterpart of ``examples/stepvideo_example.py``).

    python -m compactfusion_tpu_torch.examples.stepvideo_example --model stepfun-ai/Step-Video-T2V \\
        --height 544 --width 992 --num_frames 204 --num_inference_steps 50 --guidance_scale 9 \\
        --max_sequence_length 256 --prompt "a scenic lake at dawn"
    torchrun --nproc_per_node 8 -m compactfusion_tpu_torch.examples.stepvideo_example \\
        --tensor_parallel_degree 8 --prompt "a scenic lake at dawn"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.stepvideo_example --ring_degree 2 \\
        --compact --compact_type binary --prompt "..."

The model defaults to stepfun-ai/Step-Video-T2V (48 blocks of dim 6144, 48
heads of 128: 29.3B parameters, 58.7 GB in bf16, which one 80 GB card
holds), the size to the published 204 x 544 x 992 (36 latent frames,
18,972 tokens).  Without a checkpoint the weights are seeded random ones.
The JAX package has no Step-Video VAE, so the output is the final latent
tokens (B, tokens, 64), written as one ``.npy`` per rank under
``results/``.
"""

from __future__ import annotations

from compactfusion_tpu_torch.examples import _video
from compactfusion_tpu_torch.parallel_api import xDiTParallel


def main(argv=None):
    return _video.run(argv, "Step-Video example", "stepfun-ai/Step-Video-T2V", "stepvideo", xDiTParallel,
                      num_frames=204, height=544, width=992, guidance_scale=9.0)


if __name__ == "__main__":
    main()
