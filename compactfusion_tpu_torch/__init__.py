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
TeaCache and FBCache), the ring across ranks (``parallel/``) and the flash
profiling probes (``probes/``).  Its TPU kernels are hand-written CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).  Anything outside that slice raises
``NotImplementedError`` pointing at ``ROADMAP.md``.
"""

ROADMAP_HINT = "not ported yet; see ROADMAP.md (PyTorch/CUDA port queues)"
