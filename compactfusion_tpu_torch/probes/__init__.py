"""Profiling probes of the flash kernel, counterparts of the JAX repo's
``_prof_kernel_parts.py`` (:mod:`.flash_parts`: kernel 1's tile body with
stages switched off) and ``_prof2_dbg.py`` (:mod:`.block_parts`: the
PixArt-alpha 512 block with parts switched off or replaced), timed without
dispatch cost (:mod:`.timing`).  Run on a GPU:

    python -m compactfusion_tpu_torch.probes.flash_parts [variant ...]
    python -m compactfusion_tpu_torch.probes.block_parts [variant ...]
"""
