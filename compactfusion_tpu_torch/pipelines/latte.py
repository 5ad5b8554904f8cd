"""Latte text-to-video pipeline (counterpart of ``compactfusion_tpu/pipelines/latte.py``).

T5 states and their masks in, video out: true CFG (a doubled batch, or
split over the cfg axis), DDIM on the ``ddpm_schedule`` table, then the 2D
image VAE on every frame to (B, T, H, W, 3) in [0, 1], the reference's
per-frame ``vae.decode`` tail.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``), as
the JAX package's ``shard_map`` runs it: the text split over cfg, the batch
over dp, whole frames over the (ring, ulysses) ranks (``models/latte.py``:
spatial attention stays local, each temporal block takes two
all-to-alls); every rank gets the whole latents back.  Latte's layout has
no ring K/V exchange, so a compression config is accepted and has no
effect, as in the JAX package.  Tensor parallelism splits every block's
ffn over tp (``parallel/tp.py::local_params``: fc1 by columns, fc2 by rows,
the sum over tp), as the port's other families do; the result is the
one-process run's within the fp32 floor.  The JAX pipeline passes
``tp_axis`` but hands every rank the whole weights, so its tp-2 run sums
the whole ffn twice and leaves its one-device run
(``tests/test_torch_latte.py::test_jax_tp2_sums_whole_ffns``): the port
holds tp to the JAX one-device run, not to that.
PipeFusion has no Latte stages (neither block stack is a ``BLOCK_KEYS``
stack), so a pp rank runs the whole model on the whole weights, as the JAX
pipeline does: its latents are one process's, bit for bit.

Unlike the JAX config, :class:`LattePipelineConfig` names its VAE config
(``vae``), as the port's other pipelines do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.config import CompactConfig, ParallelConfig
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.latte import LatteConfig, latte_forward
from compactfusion_tpu_torch.models.vae import VAEConfig, sd_vae, vae_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_TP, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import ddim_step, ddpm_schedule


@dataclasses.dataclass(frozen=True)
class LattePipelineConfig:
    model: LatteConfig
    vae: VAEConfig = sd_vae()
    parallel: ParallelConfig = ParallelConfig()
    #: accepted: Latte's layout has no ring K/V exchange to compress
    compact: CompactConfig = CompactConfig()
    num_steps: int = 50
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    num_frames: int = 16

    @property
    def grid(self) -> Tuple[int, int]:
        return self.height // 8 // self.model.patch, self.width // 8 // self.model.patch

    @property
    def spatial_tokens(self) -> int:
        hp, wp = self.grid
        return hp * wp

    @property
    def tokens(self) -> int:
        return self.num_frames * self.spatial_tokens

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    def __post_init__(self):
        sp = self.parallel.sp_degree
        if self.num_frames % sp != 0:
            raise ValueError(
                f"latte: num_frames ({self.num_frames}) must be divisible "
                f"by sp_degree (ring {self.parallel.ring_degree} x ulysses "
                f"{self.parallel.ulysses_degree} = {sp}) — Latte shards "
                f"frames, not flat tokens, so spatial attention stays local"
            )


class LattePipeline:
    """User-facing pipeline: ``LattePipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``.  With ``cfg.parallel.world_size > 1`` every
    rank builds one with its ``mesh`` and calls it with the same text and
    noise."""

    def __init__(self, params, vae_params, cfg: LattePipelineConfig, device="cuda", mesh: Optional[Mesh] = None,
                 vae_mesh: Optional[Mesh] = None):
        if vae_mesh is not None:
            raise ValueError("latte: no VAE-rank path (the JAX package has none)")
        if cfg.parallel.world_size > 1 and mesh is None:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        # float32 matmuls and convolutions in full fp32 on the GPU (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        #: this rank's share: the ffns split over tp; no stage cut over pp
        self.params = local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = None
        self.device = torch.device(device)
        m = cfg.model
        hp, wp = cfg.grid
        self.sched = ddpm_schedule(cfg.num_steps)
        self.pos_embed = cm.sincos_pos_embed_2d(m.dim, hp, wp).to(self.device)
        self.temporal_pos_embed = cm._sincos_embed_1d(torch.arange(cfg.num_frames, dtype=torch.float32),
                                                      m.dim).to(self.device)

    def __call__(self, text, text_mask, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """text (2, B, S_text, text_dim) = [cond, uncond]; text_mask (2, B,
        S_text) bool or None.  Noise comes from ``latents`` (B, tokens,
        p*p*C) when given, else from ``generator``.  Returns the video (B, T,
        H, W, 3) in [0, 1], or the final latent tokens when not ``decode`` or
        without VAE params."""
        cfg = self.cfg
        if text_mask is None:
            text_mask = torch.ones(text.shape[:3], dtype=torch.bool)
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            m = cfg.model
            latents = base.prepare_latents(generator, text.shape[1], cfg.tokens, m.patch * m.patch * m.in_channels,
                                           torch.float32, self.device)
        latents = self._sample(text, text_mask, latents)
        return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, text, text_mask, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        text, text_mask = text.to(self.device), text_mask.to(self.device)
        latents = latents.to(self.device, torch.float32)
        if mesh is not None:
            # this rank's share: the batch over dp, whole frames over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            text, text_mask = text[:, rows], text_mask[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
        cfg_split = cfg.do_cfg and p.cfg_degree == 2
        if cfg_split:
            i = mesh.axis_index(AXIS_CFG)  # this rank's half: cond or uncond
            text, text_mask = text[i], text_mask[i]
        elif cfg.do_cfg:
            text, text_mask = torch.cat([text[0], text[1]], dim=0), torch.cat([text_mask[0], text_mask[1]], dim=0)
        else:
            text, text_mask = text[0], text_mask[0]
        text = text.to(m.dtype)
        b = latents.shape[0]
        nb = 2 * b if cfg.do_cfg and not cfg_split else b
        f_local = cfg.num_frames // p.sp_degree
        tp_axis = AXIS_TP if p.tp_degree > 1 else None
        for i in range(cfg.num_steps):
            t = torch.full((nb,), float(self.sched.timesteps[i]), dtype=torch.float32, device=self.device)
            x = torch.cat([latents, latents], dim=0) if nb > b else latents
            out, _ = latte_forward(self.params, x.to(m.dtype), t, text, m, frames_local=f_local,
                                   frames_total=cfg.num_frames, spatial_tokens=cfg.spatial_tokens,
                                   pos_embed=self.pos_embed, temporal_pos_embed=self.temporal_pos_embed, mesh=mesh,
                                   text_mask=text_mask, tp_axis=tp_axis)
            eps = out[..., : out.shape[-1] // 2]  # drop the learned-variance half
            if cfg.do_cfg:
                eps = base.cfg_combine(eps, cfg.guidance_scale, p.cfg_degree, mesh)
            latents = ddim_step(self.sched, i, cfg.num_steps, latents, eps)
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, T * S_sp, p*p*C) -> video (B, T, H, W, 3) in
        [0, 1]: every frame through the 2D VAE."""
        cfg, m = self.cfg, self.cfg.model
        hp, wp = cfg.grid
        b, t = latent_tokens.shape[0], cfg.num_frames
        lat = latent_tokens.to(self.device).reshape(b * t, cfg.spatial_tokens, -1)
        img = vae_decode(self.vae_params, cm.unpatchify(lat, m.patch, hp, wp, m.in_channels), cfg.vae)
        img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
        return img.reshape((b, t) + tuple(img.shape[1:]))
