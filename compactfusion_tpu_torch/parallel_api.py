"""One-call parallelization API + model registry
(counterpart of ``compactfusion_tpu/parallel_api.py``).

Reference: ``xDiTParallel`` (``xfuser/parallel.py:23-54``): look up the
pipeline for a model name, build it, warm it up, run it, save per rank.
The registry maps a model-name pattern to a builder; ``xDiTParallel`` binds
this rank's device (``parallel/mesh.py::init_distributed_environment``:
the GPU, or an error where none is visible, unless the caller asks for the
CPU), builds the mesh from the ``EngineConfig``, loads a checkpoint or
draws seeded random weights on that device, and runs prompts through the
real text path (tokenizer -> T5/CLIP -> embeddings) into the pipeline.

Every family of the JAX registry: PixArt-alpha 512 and PixArt-Sigma (1024,
2K), FLUX.1 (dev, schnell), SD3-medium, HunyuanDiT v1.2, CogVideoX (2B,
5B, 1.5-5B; text to video, the causal 3D VAE), Latte-1 (the per-frame 2D
VAE), HunyuanVideo-T2V (its causal 3D VAE), ConsisID-preview (with
``--img_file_path``: identity tokens from the face image) and
Step-Video-T2V (fully tensor-parallel; latents out, as the JAX pipeline has
no Step-Video VAE), with their ``-tiny`` test configs; the 2D VAE's
``--enable_tiling`` / ``--enable_slicing``.

Every parallel flag of the JAX runner is taken: ``--pipefusion_parallel_
degree`` (PixArt's default is the patch pipeline with M = pp; FLUX, SD3,
HunyuanDiT and CogVideoX run it sync, as their JAX builders do),
``--tensor_parallel_degree`` and ``--vae_parallel_size`` (the tail ranks
decode PixArt in bands; those of the other families stay idle, as in the
JAX package).  With VAE ranks the image
reaches the caller on rank 0; a tail rank builds no prompt encoder and
returns None.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.cache.accel import FLUX_TEACACHE_POLY, CacheAccelConfig
from compactfusion_tpu_torch.config import EngineConfig, InputConfig
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.utils.logger import init_logger

logger = init_logger(__name__)

def _cache_cfg(engine: EngineConfig, family: str = "") -> CacheAccelConfig:
    """``--use_fbcache`` / ``--use_teacache`` -> a cache config with the
    reference's default thresholds; FLUX's TeaCache takes its fitted
    degree-4 rescale polynomial."""
    rt = engine.runtime_config
    if rt.use_fbcache:
        return CacheAccelConfig(mode="fbcache", threshold=0.12)
    if rt.use_teacache:
        poly = FLUX_TEACACHE_POLY if family == "flux" else (1.0, 0.0)
        return CacheAccelConfig(mode="teacache", threshold=0.25, poly=poly)
    return CacheAccelConfig()


def classify_height_width_bin(height: int, width: int, base_px: int,
                              align: Optional[int] = None) -> Tuple[int, int]:
    """Snap a requested (height, width) to the nearest aspect-ratio bin:
    area-preserving, ``align``-aligned pairs at the model's native area, the
    closest aspect ratio wins (the JAX package's derived bins; native
    squares map to themselves)."""
    if align is None:
        align = max(16, base_px // 16)
    area = base_px * base_px
    target = height / width
    cands = set()
    for a in range(align, 2 * base_px + 1, align):
        b = int(round(area / a / align)) * align
        if b >= align:
            cands.add((a, b))
            cands.add((b, a))
    best, best_d = (base_px, base_px), abs(target - 1.0)
    for h, w in sorted(cands):
        d = abs(target - h / w)
        if d < best_d - 1e-9:
            best, best_d = (h, w), d
    return best


def resize_and_crop(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) images: aspect-preserving bilinear resize, then a
    center crop to (height, width), the output leg of resolution binning.
    Bilinear with antialiasing on the way down, as ``jax.image.resize``."""
    b, h, w, c = images.shape
    if (h, w) == (height, width):
        return images
    r = max(height / h, width / w)
    nh, nw = max(int(round(h * r)), height), max(int(round(w * r)), width)
    out = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                        align_corners=False, antialias=True).permute(0, 2, 3, 1).to(images.dtype)
    top, left = (nh - height) // 2, (nw - width) // 2
    return out[:, top:top + height, left:left + width]


def _bin_input(inp: InputConfig, base_px: int) -> InputConfig:
    """Resolution binning of the request (PixArt family)."""
    if not inp.use_resolution_binning:
        return inp
    bh, bw = classify_height_width_bin(inp.height, inp.width, base_px)
    if (bh, bw) != (inp.height, inp.width):
        logger.info("resolution binning: %dx%d -> %dx%d (native area %d^2)",
                    inp.height, inp.width, bh, bw, base_px)
        inp = dataclasses.replace(inp, height=bh, width=bw)
    return inp


@dataclasses.dataclass
class _Family:
    name: str
    pattern: str
    build: Callable[..., Any]


_REGISTRY: Dict[str, _Family] = {}


def register_family(name: str, pattern: str):
    def deco(fn):
        _REGISTRY[name] = _Family(name, pattern, fn)
        return fn

    return deco


def resolve_family(model_name: str) -> _Family:
    low = model_name.lower()
    for fam in _REGISTRY.values():
        if re.search(fam.pattern, low):
            return fam
    raise ValueError(f"no pipeline registered for model {model_name!r}; "
                     f"known: {[f.pattern for f in _REGISTRY.values()]}")


# ---------------------------------------------------------------------------
# family builders (seeded random weights on the device; a checkpoint
# directory loads the diffusers layout)
# ---------------------------------------------------------------------------


def _vae_opts(vcfg, engine: EngineConfig):
    """The runtime VAE decode memory knobs (``--enable_tiling`` /
    ``--enable_slicing``) on a 2D ``VAEConfig``; the 3D VAE's builder wires
    ``--enable_tiling`` itself."""
    rc = engine.runtime_config
    if rc.enable_tiling or rc.enable_slicing:
        vcfg = dataclasses.replace(vcfg, use_tiling=rc.enable_tiling, use_slicing=rc.enable_slicing)
    return vcfg


def _meshes(engine: EngineConfig):
    """(this rank's mesh, the VAE-tail mesh): (None, None) on one process;
    the mesh is None on a tail rank, the VAE mesh None without a tail."""
    from compactfusion_tpu_torch.parallel.mesh import make_mesh, make_vae_mesh

    par = engine.parallel_config
    if par.world_size == 1 and not par.vae_parallel_size:
        return None, None
    return make_mesh(par), make_vae_mesh(par)


def _is_tail(vae_mesh) -> bool:
    """This rank belongs to the VAE tail (it runs no denoise)."""
    from compactfusion_tpu_torch.parallel.mesh import AXIS_VAE

    return vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0


def _transformer_state(checkpoint: str):
    from compactfusion_tpu_torch.io import hf

    tdir = os.path.join(checkpoint, "transformer")
    return hf.load_safetensors(tdir if os.path.isdir(tdir) else checkpoint)


@register_family("pixart", r"pixart")
def _build_pixart(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None,
                  device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.pixart import (
        init_pixart,
        pixart_alpha_512,
        pixart_sigma_1024,
        pixart_sigma_2k,
        pixart_tiny,
    )
    from compactfusion_tpu_torch.models.vae import init_vae_decoder, sd_vae, tiny_vae
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    name = engine.model_config.model.lower()
    if "tiny" in name:  # smoke-test configs
        mcfg, vcfg = pixart_tiny(), tiny_vae()
    else:
        if "2k" in name or inp.height > 1024:
            mcfg = pixart_sigma_2k()
        elif "sigma" in name or inp.height > 512:
            mcfg = pixart_sigma_1024()
        else:
            mcfg = pixart_alpha_512()
        # PixArt-alpha ships the SD 1.x VAE (scaling 0.18215), Sigma the
        # SDXL one (0.13025)
        vcfg = sd_vae() if mcfg == pixart_alpha_512() else dataclasses.replace(sd_vae(), scaling_factor=0.13025)
    # snap to the model's native-area aspect bin; __call__ resizes back
    inp = _bin_input(inp, mcfg.sample_size * 8)
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # a VAE rank holds the decoder alone
    elif checkpoint:
        params = cm.to_device(hf.convert_pixart(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_pixart(torch.Generator(device=device).manual_seed(0), mcfg)
    if checkpoint:
        vae_params = _load_vae2d(checkpoint, vcfg, device)
    else:
        vae_params = init_vae_decoder(torch.Generator(device=device).manual_seed(1), vcfg)
    pcfg = PixArtPipelineConfig(
        model=mcfg,
        vae=_vae_opts(vcfg, engine),
        parallel=engine.parallel_config,
        compact=engine.compact_config,
        cache=_cache_cfg(engine),
        num_steps=inp.num_inference_steps,
        guidance_scale=inp.guidance_scale,
        height=inp.height,
        width=inp.width,
        # PixArt's PipeFusion defaults to the patch pipeline with M = pp
        num_pipeline_patch=engine.parallel_config.num_pipeline_patch or engine.parallel_config.pp_degree,
        runtime_warmup_steps=engine.runtime_config.warmup_steps,
    )
    return PixArtPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


@register_family("flux", r"flux")
def _build_flux(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None,
                device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.flux import flux_dev, flux_schnell, flux_tiny, init_flux
    from compactfusion_tpu_torch.models.vae import flux_vae, tiny_vae
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    name = engine.model_config.model.lower()
    if "tiny" in name:
        mcfg = flux_tiny()
        # FLUX packs 2x2 latent patches: VAE latents = in_channels // 4
        vcfg = dataclasses.replace(tiny_vae(), latent_channels=mcfg.in_channels // 4)
    else:
        mcfg = flux_schnell() if "schnell" in name else flux_dev()
        vcfg = flux_vae()
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # FLUX's VAE-tail ranks stay idle
    elif checkpoint:
        params = cm.to_device(hf.convert_flux(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_flux(torch.Generator(device=device).manual_seed(0), mcfg)
    # as the JAX package's _build_flux: FLUX runs PipeFusion sync (num_pipeline_patch 1)
    pcfg = FluxPipelineConfig(
        model=mcfg,
        vae=_vae_opts(vcfg, engine),
        parallel=engine.parallel_config,
        compact=engine.compact_config,
        cache=_cache_cfg(engine, family="flux"),
        num_steps=inp.num_inference_steps,
        guidance_scale=inp.guidance_scale,
        height=inp.height,
        width=inp.width,
    )
    vae_params = None if _is_tail(vae_mesh) else _load_vae2d(checkpoint, vcfg, device)
    return FluxPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


def _load_vae3d(checkpoint: Optional[str], vcfg, device):
    """CogVideoX-family 3D VAE decoder params: the checkpoint's ``vae/``
    subdir, or seeded random weights (seed 11, as the JAX ``_load_vae3d``)."""
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.vae3d import init_vae3d_decoder

    if checkpoint:
        vae_dir = os.path.join(checkpoint, "vae")
        if os.path.isdir(vae_dir):
            return cm.to_device(hf.convert_vae3d_decoder(hf.load_safetensors(vae_dir), vcfg), device)
    return init_vae3d_decoder(torch.Generator(device=device).manual_seed(11), vcfg)


def _build_cogvideox(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None,
                     device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.cogvideox import (
        cogvideox_1_5_5b,
        cogvideox_2b,
        cogvideox_5b,
        cogvideox_tiny,
        init_cogvideox,
    )
    from compactfusion_tpu_torch.models.vae3d import cogvideox_vae, tiny_vae3d
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig

    name = engine.model_config.model.lower()
    is_15 = "1.5" in name or "1-5" in name  # THUDM/CogVideoX1.5-5B
    if "tiny" in name:
        mcfg = cogvideox_tiny(patch_t=2 if is_15 else 1)
    elif is_15:
        mcfg = cogvideox_1_5_5b()
    else:
        mcfg = cogvideox_5b() if "5b" in name else cogvideox_2b()
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # CogVideoX's VAE-tail ranks stay idle
    elif checkpoint and os.path.isdir(os.path.join(checkpoint, "transformer")):
        params = cm.to_device(hf.convert_cogvideox(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_cogvideox(torch.Generator(device=device).manual_seed(0), mcfg)
    if "tiny" in name:
        vcfg = dataclasses.replace(tiny_vae3d(), latent_channels=mcfg.in_channels)
    else:
        vcfg = cogvideox_vae()
        if engine.runtime_config.enable_tiling:
            vcfg = dataclasses.replace(vcfg, use_tiling=True)
    pcfg = CogVideoXPipelineConfig(
        model=mcfg,
        vae=vcfg,
        parallel=engine.parallel_config,
        compact=engine.compact_config,
        num_steps=inp.num_inference_steps,
        guidance_scale=inp.guidance_scale,
        height=inp.height,
        width=inp.width,
        num_frames=inp.num_frames,
    )
    vae_params = None if _is_tail(vae_mesh) else _load_vae3d(checkpoint, vcfg, device)
    pipe = CogVideoXPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh)
    return pipe, pcfg


def _build_latte(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.latte import init_latte, latte_1, latte_tiny
    from compactfusion_tpu_torch.models.vae import sd_vae, tiny_vae
    from compactfusion_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    if "tiny" in engine.model_config.model.lower():
        mcfg, vcfg = latte_tiny(), tiny_vae()
    else:
        mcfg, vcfg = latte_1(), sd_vae()
    if checkpoint and os.path.isdir(os.path.join(checkpoint, "transformer")):
        params = cm.to_device(hf.convert_latte(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_latte(torch.Generator(device=device).manual_seed(0), mcfg)
    vcfg = _vae_opts(vcfg, engine)
    pcfg = LattePipelineConfig(model=mcfg, vae=vcfg, parallel=engine.parallel_config,
                               compact=engine.compact_config, num_steps=inp.num_inference_steps,
                               guidance_scale=inp.guidance_scale, height=inp.height, width=inp.width,
                               num_frames=inp.num_frames)
    mesh, _ = _meshes(engine)
    return LattePipeline(params, _load_vae2d(checkpoint, vcfg, device), pcfg, device, mesh=mesh), pcfg


def _build_hunyuanvideo(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.hunyuanvideo import (
        hunyuanvideo_config,
        hunyuanvideo_tiny,
        init_hunyuanvideo,
    )
    from compactfusion_tpu_torch.models.vae3d import hunyuanvideo_vae, init_hv_vae3d_decoder, tiny_hv_vae3d
    from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline, HunyuanVideoPipelineConfig

    tiny = "tiny" in engine.model_config.model.lower()
    mcfg = hunyuanvideo_tiny() if tiny else hunyuanvideo_config()
    if tiny:
        # the tokens are 2x2-packed: the VAE's latent channels are in_channels / 4
        vcfg = dataclasses.replace(tiny_hv_vae3d(), latent_channels=mcfg.in_channels // 4)
    else:
        vcfg = hunyuanvideo_vae()
        if engine.runtime_config.enable_tiling:
            vcfg = dataclasses.replace(vcfg, use_tiling=True)
    mesh, vae_mesh = _meshes(engine)
    tdir = os.path.join(checkpoint, "transformer") if checkpoint else ""
    if _is_tail(vae_mesh):
        params = None  # HunyuanVideo's VAE-tail ranks stay idle
    elif tdir and os.path.isdir(tdir):
        params = cm.to_device(hf.convert_hunyuanvideo(hf.load_safetensors(tdir), mcfg), device)
    else:
        params = init_hunyuanvideo(torch.Generator(device=device).manual_seed(0), mcfg)
    vae_params = None
    if not _is_tail(vae_mesh):
        vdir = os.path.join(checkpoint, "vae") if checkpoint else ""
        if vdir and os.path.isdir(vdir):
            vae_params = cm.to_device(hf.convert_hv_vae3d_decoder(hf.load_safetensors(vdir), vcfg), device)
        else:
            # seed 12, as the JAX builder's
            vae_params = init_hv_vae3d_decoder(torch.Generator(device=device).manual_seed(12), vcfg)
    pcfg = HunyuanVideoPipelineConfig(model=mcfg, vae=vcfg, parallel=engine.parallel_config,
                                      compact=engine.compact_config, num_steps=inp.num_inference_steps,
                                      guidance_scale=inp.guidance_scale, height=inp.height, width=inp.width,
                                      num_frames=inp.num_frames)
    return HunyuanVideoPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


def _build_consisid(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.consisid import consisid_preview, consisid_tiny, init_consisid
    from compactfusion_tpu_torch.models.face import lfe_consisid
    from compactfusion_tpu_torch.models.vae3d import cogvideox_vae, tiny_vae3d
    from compactfusion_tpu_torch.pipelines.consisid import ConsisIDPipeline, ConsisIDPipelineConfig

    tiny = "tiny" in engine.model_config.model.lower()
    mcfg = consisid_tiny() if tiny else consisid_preview()
    mesh, vae_mesh = _meshes(engine)
    lfe_params = None
    if _is_tail(vae_mesh):
        params = None  # ConsisID's VAE-tail ranks stay idle
    elif checkpoint and os.path.isdir(os.path.join(checkpoint, "transformer")):
        state = _transformer_state(checkpoint)
        params = cm.to_device(hf.convert_consisid(state, mcfg), device)
        if "local_facial_extractor.latents" in state:
            lfe_params = cm.to_device(hf.convert_local_facial_extractor(state, lfe_consisid()), device)
    else:
        params = init_consisid(torch.Generator(device=device).manual_seed(0), mcfg)
    if tiny:
        vcfg = dataclasses.replace(tiny_vae3d(), latent_channels=mcfg.in_channels)
    else:
        vcfg = cogvideox_vae()
        if engine.runtime_config.enable_tiling:
            vcfg = dataclasses.replace(vcfg, use_tiling=True)
    pcfg = ConsisIDPipelineConfig(model=mcfg, vae=vcfg, parallel=engine.parallel_config,
                                  compact=engine.compact_config, num_steps=inp.num_inference_steps,
                                  guidance_scale=inp.guidance_scale, height=inp.height, width=inp.width,
                                  num_frames=inp.num_frames)
    vae_params = None if _is_tail(vae_mesh) else _load_vae3d(checkpoint, vcfg, device)
    pipe = ConsisIDPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh)
    pipe.lfe_params = lfe_params  # the face encoder for pipe.encode_face
    return pipe, pcfg


def _build_sd3(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.sd3 import init_sd3, sd3_medium, sd3_tiny
    from compactfusion_tpu_torch.models.vae import sd3_vae, tiny_vae
    from compactfusion_tpu_torch.pipelines.sd3 import SD3Pipeline, SD3PipelineConfig

    if "tiny" in engine.model_config.model.lower():
        mcfg = sd3_tiny()
        vcfg = dataclasses.replace(tiny_vae(), latent_channels=mcfg.in_channels)
    else:
        mcfg, vcfg = sd3_medium(), sd3_vae()
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # SD3's VAE-tail ranks stay idle
    elif checkpoint:
        params = cm.to_device(hf.convert_sd3(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_sd3(torch.Generator(device=device).manual_seed(0), mcfg)
    # as the JAX package's _build_sd3: PipeFusion runs sync (num_pipeline_patch 1)
    pcfg = SD3PipelineConfig(
        model=mcfg,
        vae=_vae_opts(vcfg, engine),
        parallel=engine.parallel_config,
        compact=engine.compact_config,
        num_steps=inp.num_inference_steps,
        guidance_scale=inp.guidance_scale,
        height=inp.height,
        width=inp.width,
    )
    vae_params = None if _is_tail(vae_mesh) else _load_vae2d(checkpoint, vcfg, device)
    return SD3Pipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


def _build_hunyuan(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.hunyuandit import hunyuandit_tiny, hunyuandit_v12, init_hunyuandit
    from compactfusion_tpu_torch.models.vae import sd_vae, tiny_vae
    from compactfusion_tpu_torch.pipelines.hunyuandit import HunyuanDiTPipeline, HunyuanDiTPipelineConfig

    if "tiny" in engine.model_config.model.lower():
        mcfg, vcfg = hunyuandit_tiny(), tiny_vae()
    else:
        # HunyuanDiT ships the SDXL 4-channel VAE (scaling 0.13025)
        mcfg, vcfg = hunyuandit_v12(), dataclasses.replace(sd_vae(), scaling_factor=0.13025)
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # HunyuanDiT's VAE-tail ranks stay idle
    elif checkpoint and os.path.isdir(os.path.join(checkpoint, "transformer")):
        params = cm.to_device(hf.convert_hunyuandit(_transformer_state(checkpoint), mcfg), device)
    else:
        params = init_hunyuandit(torch.Generator(device=device).manual_seed(0), mcfg)
    pcfg = HunyuanDiTPipelineConfig(
        model=mcfg,
        vae=_vae_opts(vcfg, engine),
        parallel=engine.parallel_config,
        compact=engine.compact_config,
        num_steps=inp.num_inference_steps,
        guidance_scale=inp.guidance_scale,
        height=inp.height,
        width=inp.width,
    )
    vae_params = None if _is_tail(vae_mesh) else _load_vae2d(checkpoint, vcfg, device)
    return HunyuanDiTPipeline(params, vae_params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


def _build_stepvideo(engine: EngineConfig, inp: InputConfig, checkpoint: Optional[str] = None, device="cuda"):
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.stepvideo import init_stepvideo, stepvideo_t2v, stepvideo_tiny
    from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipeline, StepVideoPipelineConfig

    mcfg = stepvideo_tiny() if "tiny" in engine.model_config.model.lower() else stepvideo_t2v()
    mesh, vae_mesh = _meshes(engine)
    if _is_tail(vae_mesh):
        params = None  # Step-Video's VAE-tail ranks stay idle
    elif checkpoint and os.path.isdir(os.path.join(checkpoint, "transformer")):
        params = cm.to_device(hf.convert_stepvideo(_transformer_state(checkpoint), mcfg), device)
    else:
        # drawn one layer at a time on the device (init_stepvideo)
        params = init_stepvideo(torch.Generator(device=device).manual_seed(0), mcfg)
    pcfg = StepVideoPipelineConfig(model=mcfg, parallel=engine.parallel_config, compact=engine.compact_config,
                                   num_steps=inp.num_inference_steps, guidance_scale=inp.guidance_scale,
                                   height=inp.height, width=inp.width, num_frames=inp.num_frames)
    return StepVideoPipeline(params, pcfg, device, mesh=mesh, vae_mesh=vae_mesh), pcfg


# the JAX registry's other families, in its order and with its patterns
for _name, _pattern, _build in (
        ("sd3", r"stable-diffusion-3|sd3", _build_sd3), ("cogvideox", r"cogvideo", _build_cogvideox),
        ("latte", r"latte", _build_latte), ("hunyuanvideo", r"hunyuanvideo", _build_hunyuanvideo),
        ("consisid", r"consisid", _build_consisid), ("stepvideo", r"step[-_]?video", _build_stepvideo),
        ("hunyuandit", r"hunyuan(?!.?video)", _build_hunyuan)):
    register_family(_name, _pattern)(_build)


def _load_vae2d(checkpoint: Optional[str], vcfg, device):
    """2D image-VAE decoder params: the checkpoint's ``vae/`` subdir, or
    seeded random weights (seed 11, as the JAX ``_load_vae2d``).
    FLUX-era AutoencoderKL checkpoints drop ``post_quant_conv``: an identity
    1x1 conv stands in, so the decoder math is shared."""
    from compactfusion_tpu_torch.io import hf
    from compactfusion_tpu_torch.models.vae import init_vae_decoder

    if checkpoint:
        vae_dir = os.path.join(checkpoint, "vae")
        if os.path.isdir(vae_dir):
            state = hf.load_safetensors(vae_dir)
            if "post_quant_conv.weight" not in state:
                c = vcfg.latent_channels
                state["post_quant_conv.weight"] = np.eye(c, dtype=np.float32).reshape(c, c, 1, 1)
                state["post_quant_conv.bias"] = np.zeros(c, np.float32)
            return cm.to_device(hf.convert_vae_decoder(state, vcfg), device)
    return init_vae_decoder(torch.Generator(device=device).manual_seed(11), vcfg)


def fast_attn_cache_path(model: str, num_steps: int, depth: int, fa) -> str:
    """The DiTFastAttn plan cache of ``model`` at ``num_steps`` x ``depth``
    under the ``FastAttnConfig`` ``fa``:
    ``.cftpu_fastattn_torch_<model>_<steps>s_<depth>l_w<window>_t<threshold>.json``,
    the JAX package's name with ``torch_``, so a plan the JAX package
    calibrated is never read here."""
    model_tag = re.sub(r"[^A-Za-z0-9._-]", "_", model)
    return f".cftpu_fastattn_torch_{model_tag}_{num_steps}s_{depth}l_w{fa.window_size}_t{fa.threshold:g}.json"


class xDiTParallel:
    """One-call parallel runner (reference ``xfuser/parallel.py:23-54``).

    ``xDiTParallel(engine_config, input_config, checkpoint=None,
    device="cuda")``: with ``parallel_config.world_size > 1`` every rank of
    a ``torchrun`` (or an initialised process group) builds one.  Prompts go
    through the real text path (``models/prompt.py``): with a checkpoint
    directory its tokenizers and encoders, without one byte-level
    tokenizers over seeded random weights.  Random weights are drawn on the
    bound device from ``torch.Generator``s seeded 0 (backbone), 1 (PixArt's
    VAE; FLUX's and CogVideoX's 11, as ``_load_vae2d`` and ``_load_vae3d``)
    and 7 (the prompt encoder), as the JAX builders seed ``PRNGKey``s: other
    draws, the same trees (SD3 and HunyuanDiT: backbone 0, VAE 11;
    Step-Video: backbone 0, drawn one layer at a time, and no VAE).
    """

    def __init__(self, engine_config: EngineConfig, input_config: InputConfig,
                 checkpoint: Optional[str] = None, device: str = "cuda"):
        from compactfusion_tpu_torch.parallel.mesh import init_distributed_environment

        self.engine_config = engine_config
        self.input_config = input_config
        # binds cuda:<local_rank> or raises where no GPU is visible; joins
        # the torchrun process group when WORLD_SIZE > 1
        self.device = init_distributed_environment("nccl" if device == "cuda" else "gloo", device)
        fam = resolve_family(engine_config.model_config.model)
        logger.info("building %s pipeline on %s (world size %d)", fam.name, self.device,
                    engine_config.parallel_config.world_size)
        self.family = fam.name
        self.pipeline, self.pipeline_config = fam.build(engine_config, input_config, checkpoint, self.device)
        #: a rank of the VAE tail: no denoise, no text
        self.tail = _is_tail(self.pipeline.vae_mesh)
        if engine_config.runtime_config.quantize_backbone and not self.tail:
            self._quantize_backbone_int8()
        self.prompt_encoder = None if self.tail else self._build_prompt_encoder(checkpoint)
        if engine_config.fast_attn_config.use_fast_attn and not self.tail:
            self._apply_fast_attn(engine_config.fast_attn_config)

    def _apply_fast_attn(self, fa, latents: Optional[torch.Tensor] = None):
        """DiTFastAttn: calibrate on captions -> a per-(step, layer) method
        plan -> a JSON cache -> run with the plan.  PixArt family, sp/pp
        degree 1 and compression off (else a warning and no plan, as in
        JAX).  At tp > 1 only a cached plan runs (``fa.use_cache`` and the
        file present, of shape (steps, depth)): a tp rank's attention is
        whole, so the plan applies unchanged on every rank.  Without one, a
        warning and no plan: calibrating needs one process (the JAX package
        asserts one device there).  The calibration noise is ``latents``
        when given, else drawn from the request seed.  The cache file is
        :func:`fast_attn_cache_path` in the working directory."""
        from compactfusion_tpu_torch.cache.fast_attn import calibrate_pixart, load_plan, save_plan

        if self.family != "pixart":
            logger.warning("use_fast_attn: only the PixArt family is wired; ignoring")
            return
        pcfg = self.pipeline_config
        par = pcfg.parallel
        if par.sp_degree > 1 or par.pp_degree > 1 or pcfg.compact.enabled:
            logger.warning("use_fast_attn needs sp/pp degree 1 and compression off; ignoring")
            return
        mcfg = pcfg.model
        cache_path = fast_attn_cache_path(self.engine_config.model_config.model, pcfg.num_steps, mcfg.depth, fa)
        plan = None
        if fa.use_cache and os.path.exists(cache_path):
            plan = load_plan(cache_path)
            if plan.shape != (pcfg.num_steps, mcfg.depth):
                plan = None  # a cache of another config
        if plan is None and par.tp_degree > 1:
            logger.warning("use_fast_attn at tp degree %d runs only a cached plan (--use_cache and %s); "
                           "calibrating needs tp degree 1; ignoring", par.tp_degree, cache_path)
            return
        if plan is None:
            # calibration captions: the COCO file when given, else the request's prompts
            prompts = list(self.input_config.prompt)
            if fa.coco_path and os.path.exists(fa.coco_path):
                with open(fa.coco_path) as f:
                    anno = json.load(f)
                n = max(fa.n_calib, 1)
                if isinstance(anno, list):
                    prompts = [str(c) for c in anno[:n]]
                else:
                    prompts = [d["caption"] for d in anno["annotations"][:n]]
            txt, mask = self.prompt_encoder.encode_for_pixart(
                prompts, [""] * len(prompts), max_length=self.input_config.max_sequence_length)
            cal_cfg = dataclasses.replace(pcfg, fast_attn_window=fa.window_size)
            logger.info("DiTFastAttn: calibrating %d steps x %d layers", pcfg.num_steps, mcfg.depth)
            gen = torch.Generator(device=self.device).manual_seed(self.input_config.seed)
            plan = calibrate_pixart(self.pipeline.params, cal_cfg, txt, mask, generator=gen,
                                    threshold=fa.threshold, latents=latents)
            if fa.use_cache:
                save_plan(plan, cache_path)
        self.pipeline = self.pipeline.with_fast_attn(plan, fa.window_size)
        self.pipeline_config = self.pipeline.cfg

    #: the per-layer block stacks that ``--quantize_backbone_int8`` quantizes
    #: (embedders and heads stay in the model dtype)
    _INT8_BLOCK_KEYS = {"pixart": ("blocks",), "flux": ("double_blocks", "single_blocks"), "sd3": ("blocks",),
                        "hunyuandit": ("down_blocks", "up_blocks"), "cogvideox": ("blocks",),
                        "latte": ("spatial_blocks", "temporal_blocks"), "consisid": ("blocks",),
                        "hunyuanvideo": ("double_blocks", "single_blocks")}

    def _quantize_backbone_int8(self):
        """``--quantize_backbone_int8``: int8 weights for the block stacks
        (``cm.quantize_params_int8``; each matmul reads its weight
        dequantized to the activation dtype).  Step-Video has no int8 key
        map, as in the JAX package: a warning, and the weights stay bf16."""
        par = self.engine_config.parallel_config
        assert par.tp_degree == 1 and par.pp_degree == 1, (
            "--quantize_backbone_int8 composes with dp/cfg/SP (weights replicated), not tp/pp")
        keys = self._INT8_BLOCK_KEYS.get(self.family)
        if keys is None:
            logger.warning("quantize_backbone_int8: no int8 key map for family %s; weights stay bf16", self.family)
            return
        self.pipeline.params = cm.quantize_params_int8(self.pipeline.params, keys=keys)
        logger.info("backbone block stacks %s quantized to int8", ", ".join(keys))

    def _build_prompt_encoder(self, checkpoint: Optional[str]):
        enc = self._make_prompt_encoder(checkpoint)
        if self.engine_config.runtime_config.quantize_t5 and enc.t5 is not None:
            # --use_int8_t5_encoder / --use_fp8_t5_encoder
            from compactfusion_tpu_torch.models.text_encoders import quantize_t5_int8

            enc.t5.params = quantize_t5_int8(enc.t5.params)
            logger.info("T5 encoder weights quantized to int8")
        return enc

    def _make_prompt_encoder(self, checkpoint: Optional[str]):
        from compactfusion_tpu_torch.models.prompt import PromptEncoder

        mcfg = self.pipeline_config.model
        if checkpoint and any(os.path.isdir(os.path.join(checkpoint, d)) for d in ("tokenizer", "tokenizer_2")):
            from compactfusion_tpu_torch.models.text_encoders import clip_g, clip_l, clip_l_proj, t5_xxl

            if self.family == "sd3":
                return PromptEncoder.from_pretrained(checkpoint, t5_cfg=t5_xxl(), clip_l_cfg=clip_l_proj(),
                                                     clip_g_cfg=clip_g(), device=self.device)
            if self.family == "flux":
                return PromptEncoder.from_pretrained(checkpoint, t5_cfg=t5_xxl(), clip_l_cfg=clip_l(),
                                                     device=self.device)
            return PromptEncoder.from_pretrained(checkpoint, t5_cfg=t5_xxl(), device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(7)
        if self.family == "flux":
            return PromptEncoder.random(gen, text_dim=mcfg.text_dim, pooled_dim=mcfg.pooled_dim)
        if self.family == "sd3":
            lo = min(768, mcfg.pooled_dim // 2)
            return PromptEncoder.random(gen, text_dim=mcfg.text_dim, pooled_dim=lo, clip_g_dim=mcfg.pooled_dim - lo)
        return PromptEncoder.random(gen, text_dim=mcfg.text_dim)

    def _encode_identity(self, img_path: str) -> torch.Tensor:
        """``--img_file_path`` -> ConsisID identity tokens (B, id_tokens,
        id_dim), the same for every prompt: with the checkpoint's face encoder
        the image features run through it, else the seeded stand-in
        projection gives them (``models/face.py``), as the JAX runner does."""
        from compactfusion_tpu_torch.models.face import image_face_features, image_to_id_states, lfe_consisid

        pcfg = self.pipeline_config
        lfe_params = self.pipeline.lfe_params
        if lfe_params is not None:
            lcfg = lfe_consisid()
            id_cond, id_vit = image_face_features(img_path, lcfg, self.device)
            states = self.pipeline.encode_face(lfe_params, id_cond, id_vit, lcfg)[:, :pcfg.id_tokens]
        else:
            states = image_to_id_states(img_path, pcfg.id_tokens, pcfg.model.id_dim, self.device)
        b = len(self.input_config.prompt)
        return states.expand((b,) + tuple(states.shape[1:]))

    def prepare_run(self, generator: Optional[torch.Generator] = None):
        """Warm-up call (reference ``pipe.prepare_run``): one generation,
        waited for, before serving traffic."""
        t0 = time.perf_counter()
        self(generator=generator)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info("prepare_run: warmed up in %.1f s", time.perf_counter() - t0)
        return self

    def __call__(self, generator: Optional[torch.Generator] = None, decode: Optional[bool] = None,
                 latents: Optional[torch.Tensor] = None):
        """Run the request in ``input_config``: images (B, H, W, 3) in [0, 1]
        (the video families: videos (B, T, H, W, 3)), or the final latents with
        ``output_type="latent"`` or ``decode=False``.  With VAE ranks the
        images reach rank 0 alone: the other ranks, and the tail ranks,
        return None.
        Noise: ``latents`` when given, else drawn from ``generator``
        (default: one seeded with ``input_config.seed`` on the device)."""
        if self.engine_config.runtime_config.use_profiler:
            from compactfusion_tpu_torch.utils.prof import Profiler

            with Profiler.scope("total"):
                out = self._generate(generator, decode, latents)
            logger.info("profiler summary:\n%s", Profiler.summary())
            return out
        return self._generate(generator, decode, latents)

    def _generate(self, generator=None, decode=None, latents=None):
        inp = self.input_config
        if decode is None:
            decode = inp.output_type != "latent"
        if generator is None and latents is None:
            generator = torch.Generator(device=self.device).manual_seed(inp.seed)
        prompts = list(inp.prompt)
        if self.tail:
            if self.family == "pixart" and decode:
                self.pipeline.decode_band(len(prompts))
            return None
        negative = list(inp.negative_prompt) * (len(prompts) if len(inp.negative_prompt) == 1 else 1)
        seq = inp.max_sequence_length
        enc = self.prompt_encoder
        if self.family == "flux":
            txt, pooled = enc.encode_for_flux(prompts, max_length=seq)
            return self.pipeline(txt, pooled, generator=generator, latents=latents, decode=decode)
        if self.family == "sd3":
            txt, pooled = enc.encode_for_sd3(prompts, negative, max_length=seq)
            return self.pipeline(txt, pooled, generator=generator, latents=latents, decode=decode)
        if self.family in ("cogvideox", "consisid", "stepvideo"):
            # (2, B, S, D) cond/uncond T5 states at max_sequence_length, no mask
            txt = enc.encode_for_video(prompts, negative, max_length=seq)
            if self.family == "stepvideo" and self.device.type == "cuda":
                # the encoder's freed activations leave PyTorch's cache
                # before the 30B denoise
                torch.cuda.empty_cache()
            if self.family == "consisid":
                ids = self._encode_identity(inp.img_file_path) if inp.img_file_path else None
                return self.pipeline(txt, generator=generator, latents=latents, id_states=ids, decode=decode)
            return self.pipeline(txt, generator=generator, latents=latents, decode=decode)
        if self.family == "hunyuanvideo":
            # the cond states only (embedded guidance), all tokens valid, zero pooled vector
            txt = enc.encode_for_video(prompts, negative, max_length=seq)
            return self.pipeline(txt, generator=generator, latents=latents, decode=decode)
        # PixArt, HunyuanDiT and Latte: (2, B, S, D) states and their masks
        txt, mask = enc.encode_for_pixart(prompts, negative, max_length=seq)
        out = self.pipeline(txt, mask, generator=generator, latents=latents, decode=decode)
        pcfg = self.pipeline_config
        if (decode and out is not None and self.family == "pixart"
                and (pcfg.height, pcfg.width) != (inp.height, inp.width)):
            # binning changed the generation size: resize back to the request
            out = resize_and_crop(out, inp.height, inp.width)
        return out

    def save(self, directory: str, prefix: str = "cftpu", out=None):
        """Write outputs of this rank (reference ``xDiTParallel.save``):
        images as PNG, one per batch element (``utils/image.py``, no PIL);
        videos and latents as ``.npy``.  ``out``: an already generated result.
        A rank that holds no result (a VAE-tail rank, or a rank other than 0
        with VAE ranks) writes nothing and returns None."""
        import torch.distributed as dist

        from compactfusion_tpu_torch.utils.image import to_uint8, write_png

        out = self() if out is None else out
        if out is None:
            return None
        os.makedirs(directory, exist_ok=True)
        arr = out.float().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
        rank = dist.get_rank() if dist.is_initialized() else 0
        if arr.ndim == 4 and arr.shape[-1] == 3:  # (B, H, W, 3) in [0, 1]
            img8 = to_uint8(arr)
            paths = []
            for i in range(img8.shape[0]):
                path = os.path.join(directory, f"{prefix}_rank{rank}_{i}.png")
                write_png(path, img8[i])
                paths.append(path)
            return paths[0] if len(paths) == 1 else paths
        path = os.path.join(directory, f"{prefix}_rank{rank}.npy")
        np.save(path, arr)
        return path
