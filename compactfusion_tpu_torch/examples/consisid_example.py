"""ConsisID example (counterpart of ``examples/consisid_example.py``).

    python -m compactfusion_tpu_torch.examples.consisid_example --model BestWishYsh/ConsisID-preview \\
        --height 480 --width 720 --num_frames 49 --num_inference_steps 50 --guidance_scale 6 \\
        --max_sequence_length 226 --img_file_path face.png --prompt "a woman smiling in a garden"
    torchrun --nproc_per_node 2 -m compactfusion_tpu_torch.examples.consisid_example --ring_degree 2 \\
        --max_sequence_length 226 --compact --compact_type binary --img_file_path face.png --prompt "..."

The model defaults to BestWishYsh/ConsisID-preview and the frames to 49.
``--img_file_path`` (a PNG) gives the identity tokens: through the
checkpoint's face encoder where it has one, else through the seeded
stand-in projection (``models/face.py``).  49 x 480 x 720 gives 17,550
video tokens, which ring 2, Ulysses 2 and cfg 2 split and Ulysses 2 x ring 2
does not.  Writes the video (B, T, H, W, 3) in [0, 1] as one ``.npy`` per
rank under ``results/``.
"""

from __future__ import annotations

from compactfusion_tpu_torch.examples import _video
from compactfusion_tpu_torch.parallel_api import xDiTParallel


def main(argv=None):
    return _video.run(argv, "ConsisID example", "BestWishYsh/ConsisID-preview", "consisid", xDiTParallel,
                      num_frames=49)


if __name__ == "__main__":
    main()
