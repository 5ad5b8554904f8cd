"""Stable Diffusion 3 text-to-image pipeline
(counterpart of ``compactfusion_tpu/pipelines/sd3.py``).

Text states (CLIP-L ++ CLIP-G, zero-padded to the T5 width, then the T5
rows) and the pooled CLIP vectors go in, images come out: true CFG as a
doubled batch or split over the cfg axis, flow-match Euler with the static
shift of 3.0, then the 16-channel VAE decode with its shift factor.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``),
each rank runs its share, as the JAX package's ``shard_map`` does: the
text split over cfg, the batch over dp, the image tokens over (ring,
ulysses), the text replicated as the attention's joint front tensors; the
sequence-parallel attention plain (``USPAttn``) or compressed
(``CompactUSPAttn``), fused or not (``use_fused_ring``), with one strategy
and one EF state per layer segment of a per-layer plan.  Each rank holds
its part of the params (``parallel/tp.py``): with ``pp_degree`` > 1 its
stage's blocks, run as sync PipeFusion (``num_pipeline_patch`` 1) or as
the patch pipeline (``pipelines/sd3_patch_pp.py``); with ``tp_degree`` > 1
its share of both streams' ffns.  SD3 has no VAE-rank path, as in the JAX
package: with ``vae_parallel_size`` the tail ranks stay idle and return
None, and the DiT ranks decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.config import (
    CompactConfig,
    CompressType,
    ParallelConfig,
    validate_parallel_geometry,
)
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import CompactUSPAttn, SingleDeviceAttn, USPAttn
from compactfusion_tpu_torch.models.sd3 import SD3Config, sd3_forward
from compactfusion_tpu_torch.models.vae import VAEConfig, vae_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_TP, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.flow_match import flow_match_schedule, flow_match_step


@dataclasses.dataclass(frozen=True)
class SD3PipelineConfig:
    model: SD3Config
    vae: VAEConfig
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    num_steps: int = 28
    guidance_scale: float = 7.0
    shift: float = 3.0
    height: int = 1024
    width: int = 1024
    #: PipeFusion micro-patches per image (M > 1 with pp > 1: the patch
    #: pipeline, reference --num_pipeline_patch)
    num_pipeline_patch: int = 1
    #: full-sequence sync steps before patch mode
    runtime_warmup_steps: int = 1

    @property
    def grid(self) -> Tuple[int, int]:
        return self.height // 8 // self.model.patch, self.width // 8 // self.model.patch

    @property
    def tokens(self) -> int:
        hp, wp = self.grid
        return hp * wp

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    @property
    def patch_pipelined(self) -> bool:
        return self.parallel.pp_degree > 1 and self.num_pipeline_patch > 1

    def __post_init__(self):
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens,
                                   depth=self.model.depth, num_pipeline_patch=self.num_pipeline_patch,
                                   family="sd3")


def _attn_impl(cfg: SD3PipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    c, p = cfg.compact, cfg.parallel
    if c.enabled:
        return CompactUSPAttn(cfg=c, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


class SD3Pipeline:
    """User-facing pipeline: ``SD3Pipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``.  With ``cfg.parallel.world_size > 1`` every
    rank builds one with its ``mesh`` and calls it with the same text and
    noise."""

    def __init__(self, params, vae_params, cfg: SD3PipelineConfig, device="cuda",
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: SD3 gives it no work
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        # float32 matmuls and convolutions in full fp32 on the GPU (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # this rank's stage of the blocks and share of the ffns
        self.params = None if self.tail else local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        self.device = torch.device(device)
        m = cfg.model
        hp, wp = cfg.grid
        self.pos_embed = cm.cropped_pos_embed_2d(m.dim, hp, wp, m.pos_embed_max_size, m.base_size).to(self.device)
        self.sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift)

    def __call__(self, txt, pooled, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """txt (2, B, S_txt, text_dim) and pooled (2, B, pooled_dim), each
        [cond, uncond].  Noise comes from ``latents`` (B, tokens, p*p*C)
        when given, else from ``generator``.  Returns images (B, H, W, 3) in
        [0, 1], or the final latent tokens when not ``decode``; None on an
        idle VAE-tail rank."""
        cfg = self.cfg
        if self.tail:
            return None
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            m = cfg.model
            latents = base.prepare_latents(generator, txt.shape[1], cfg.tokens, m.patch ** 2 * m.in_channels,
                                           torch.float32, self.device)
        if cfg.patch_pipelined:
            from compactfusion_tpu_torch.pipelines.sd3_patch_pp import sd3_patch_pp_sample

            latents = sd3_patch_pp_sample(self, txt, pooled, latents)
        else:
            latents = self._sample(txt, pooled, latents)
        return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, txt, pooled, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        txt, pooled = txt.to(self.device), pooled.to(self.device)
        latents = latents.to(self.device, torch.float32)
        if mesh is not None:
            # this rank's share: the batch over dp, the image tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            txt, pooled = txt[:, rows], pooled[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
        txt, pooled = base.split_cfg(txt, pooled, cfg.do_cfg, p.cfg_degree, mesh)
        b, s_local = latents.shape[:2]
        nb = txt.shape[0]
        pos_embed = base.slice_local_tokens(self.pos_embed, mesh, p.ulysses_degree, p.ring_degree)
        tp_axis = AXIS_TP if p.tp_degree > 1 else None

        attn_state = None
        for plan, steps in base.compact_layer_segments(cfg.compact, cfg.num_steps, m.depth):
            if isinstance(plan, tuple):  # per-layer plan: one strategy per layer segment
                attn = tuple((_attn_impl(cfg, method, mesh), n_l) for method, n_l in plan)
            else:
                attn = _attn_impl(cfg, plan, mesh)

            def fresh(dev, attn=attn):
                def init(a, n_layers):
                    return a.init_state(n_layers, nb, s_local, m.heads, m.head_dim, torch.float32, dev)
                if isinstance(attn, tuple):
                    return tuple(init(a, n_l) for a, n_l in attn)
                return init(attn, m.depth // p.pp_degree)  # this stage's layers

            attn_state = base.carry_ef_state(attn_state, fresh, self.device)
            for i in steps:
                t = torch.full((nb,), float(self.sched.timesteps[i]), dtype=torch.float32, device=self.device)
                x = torch.cat([latents, latents], dim=0) if nb > b else latents
                v, attn_state = sd3_forward(self.params, x.to(m.dtype), txt.to(m.dtype), pooled, t, m,
                                            pos_embed=pos_embed, attn=attn, attn_state=attn_state,
                                            tp_axis=tp_axis, pp_stages=p.pp_degree, mesh=mesh)
                if cfg.do_cfg:
                    v = base.cfg_combine(v, cfg.guidance_scale, p.cfg_degree, mesh)
                latents = flow_match_step(self.sched, i, latents, v)
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, tokens, p*p*C) -> images (B, H, W, 3) in [0, 1]."""
        m = self.cfg.model
        hp, wp = self.cfg.grid
        lat = cm.unpatchify(latent_tokens.to(self.device), m.patch, hp, wp, m.in_channels)
        return torch.clamp(vae_decode(self.vae_params, lat, self.cfg.vae) * 0.5 + 0.5, 0.0, 1.0)
