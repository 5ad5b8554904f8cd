"""PyTorch/CUDA port of ``compactfusion_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
(``models/pixart.py`` here is the counterpart of
``compactfusion_tpu/models/pixart.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and never
``jax`` or ``compactfusion_tpu``.

Ported so far: the PixArt-alpha 512 text-to-image path on one GPU, with and
without the single-device compressed-ring emulation (``simulate_ring``),
with every codec, residual order, int8-quantized EF caches, ``simulate``
mode and per-layer ``compress_func`` plans, and the single-device
accelerators (``cache/``: DiTFastAttn plans and their calibration,
TeaCache and FBCache), parallelism across ranks (``parallel/``: the ring,
Ulysses and the hybrid USP, the patch-parallel gather with CompactFusion's
compressed all-gather and DistriFusion's stale gather, PipeFusion sync and
patch-pipelined, tensor parallelism and the VAE ranks' banded decode) and
the flash profiling probes (``probes/``); and FLUX.1 (``models/flux.py``,
``pipelines/flux.py``: flow-match Euler with embedded guidance, the
16-channel VAE, the text as the ring's joint tensors, its checkpoint
converter in ``io/hf.py``); the entry points (``args.py``, ``parallel_api.py``, the
prompt encoders, the HTTP service, ``examples/``); CogVideoX text-to-video
(``models/cogvideox.py``, ``pipelines/cogvideox.py``: v-prediction DDIM on
the zero-terminal-SNR schedule with dynamic CFG, the causal 3D VAE in
``models/vae3d.py``); SD3-medium (``models/sd3.py``, ``pipelines/sd3.py``
and its patch pipeline), HunyuanDiT v1.2 (``models/hunyuandit.py``,
``pipelines/hunyuandit.py``: the long skips, mirrored between pipeline
stages) and PixArt-Sigma 1024 and 2K; the 2D VAE's tiled and sliced
decode; Latte-1 (``models/latte.py``: frame-aligned sequence parallelism),
ConsisID (``models/consisid.py``, the face encoder in ``models/face.py``)
and HunyuanVideo (``models/hunyuanvideo.py``, the causal HV VAE in
``models/vae3d.py``); Step-Video-T2V (``models/stepvideo.py``,
``pipelines/stepvideo.py``: tensor-parallel throughout, latents out); and
the compression statistics and activation collector (``compact/stats.py``,
``utils/collector.py``); and around the core, the environment registry
(``envs.py``), the quality metrics and their feature extractors (``eval/``:
PSNR, SSIM, LPIPS on VGG16, InceptionV3 for FID, I3D for FVD), the DDPM
ancestral step, the offline plots (``utils/tensor_viz.py``) and the
per-layer-schedule and external-USP examples.  Its TPU kernels are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).  What the port leaves out on purpose (the XLA cache,
``jit_init``, ``scan_segments``, the TPU-only flash flags) is listed in
``ROADMAP.md``.
"""

ROADMAP_HINT = "not ported yet; see ROADMAP.md (PyTorch/CUDA port queues)"

from compactfusion_tpu_torch.config import (  # noqa: E402,F401
    CompactConfig,
    EngineConfig,
    InputConfig,
    ModelConfig,
    ParallelConfig,
    RuntimeConfig,
)
from compactfusion_tpu_torch.parallel.mesh import make_mesh  # noqa: E402,F401
