"""HunyuanDiT text-to-image pipeline
(counterpart of ``compactfusion_tpu/pipelines/hunyuandit.py``).

Text states (2, B, S, text_dim) with their padding masks go in, images
come out: true CFG as a doubled batch or split over the cfg axis,
DPM-Solver++ 2M on the DDPM table, the learned-variance half of the output
dropped, then the SDXL VAE decode.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``),
each rank runs its share, as the JAX package's ``shard_map`` does: the text
split over cfg, the batch over dp, the image tokens and their rope rows
over (ring, ulysses); the sequence-parallel attention plain (``USPAttn``)
or compressed (``CompactUSPAttn``) over both halves of the blocks, each
half with its own EF state (a per-layer plan may segment the halves
differently).  Each rank holds its part of the params (``parallel/
tp.py``): with ``pp_degree`` > 1 its stage's down and up blocks, run as
sync PipeFusion with the mirror skip channel (``num_pipeline_patch`` 1) or
as the patch pipeline (``pipelines/hunyuandit_patch_pp.py``); with
``tp_degree`` > 1 its share of every ffn.  HunyuanDiT has no VAE-rank
path, as in the JAX package: the tail ranks stay idle and return None.
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
from compactfusion_tpu_torch.models.hunyuandit import HunyuanDiTConfig, hunyuandit_forward, hunyuandit_positions
from compactfusion_tpu_torch.models.vae import VAEConfig, vae_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_TP, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import ddpm_schedule, dpm_init_state, dpm_step


@dataclasses.dataclass(frozen=True)
class HunyuanDiTPipelineConfig:
    model: HunyuanDiTConfig
    vae: Optional[VAEConfig] = None
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    num_steps: int = 25
    guidance_scale: float = 5.0
    height: int = 1024
    width: int = 1024
    #: PipeFusion micro-patches per image (M > 1 with pp > 1: the patch
    #: pipeline with the skip train)
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
        if self.model.depth % 2:
            raise ValueError("hunyuandit: depth must be even (depth/2 down + depth/2 up "
                             "mirror halves with long skips)")
        # each mirror half splits over pp on its own (the skip channel pairs
        # stage i with stage pp-1-i)
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens,
                                   depth=self.model.depth // 2, num_pipeline_patch=self.num_pipeline_patch,
                                   patch_pp_min_factor=2, family="hunyuandit")


def _attn_impl(cfg: HunyuanDiTPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    c, p = cfg.compact, cfg.parallel
    if c.enabled:
        return CompactUSPAttn(cfg=c, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


class HunyuanDiTPipeline:
    """User-facing pipeline: ``HunyuanDiTPipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``.  With ``cfg.parallel.world_size > 1`` every
    rank builds one with its ``mesh`` and calls it with the same text and
    noise."""

    def __init__(self, params, vae_params, cfg: HunyuanDiTPipelineConfig, device="cuda",
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: HunyuanDiT gives it no work
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = None if self.tail else local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        self.device = torch.device(device)
        self.rope = cm.rope_frequencies(hunyuandit_positions(*cfg.grid, self.device), cfg.model.rope_axes)
        self.sched = ddpm_schedule(cfg.num_steps)

    def __call__(self, text, text_mask, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """text (2, B, S_text, text_dim) = [cond, uncond]; text_mask (2, B,
        S_text) bool or None.  Noise comes from ``latents`` (B, tokens,
        p*p*C) when given, else from ``generator``.  Returns images (B, H,
        W, 3) in [0, 1], or the final latent tokens when not ``decode``;
        None on an idle VAE-tail rank."""
        cfg = self.cfg
        if self.tail:
            return None
        if text_mask is None:
            text_mask = torch.ones(text.shape[:3], dtype=torch.bool)
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            m = cfg.model
            latents = base.prepare_latents(generator, text.shape[1], cfg.tokens, m.patch ** 2 * m.in_channels,
                                           torch.float32, self.device)
        if cfg.patch_pipelined:
            from compactfusion_tpu_torch.pipelines.hunyuandit_patch_pp import hunyuandit_patch_pp_sample

            latents = hunyuandit_patch_pp_sample(self, text, text_mask, latents)
        else:
            latents = self._sample(text, text_mask, latents)
        return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, text, text_mask, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        text, text_mask = text.to(self.device), text_mask.to(self.device)
        latents = latents.to(self.device, torch.float32)
        cos, sin = self.rope
        if mesh is not None:
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            text, text_mask = text[:, rows], text_mask[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
            cos, sin = (base.slice_local_tokens(t, mesh, p.ulysses_degree, p.ring_degree) for t in (cos, sin))
        text, text_mask = base.split_cfg(text, text_mask, cfg.do_cfg, p.cfg_degree, mesh)
        text = text.to(m.dtype)
        b, s_local = latents.shape[:2]
        nb = text.shape[0]
        half = m.depth // 2
        tp_axis = AXIS_TP if p.tp_degree > 1 else None

        dpm_state = dpm_init_state(latents.shape, self.device)
        state_d = state_u = None
        for method, steps in base.compact_two_family_segments(cfg.compact, cfg.num_steps, half, half):
            if isinstance(method, tuple):  # per-layer (down, up) plans
                if p.pp_degree > 1:
                    raise ValueError("per-layer compress_func plans need pp_degree == 1")
                attn_d = tuple((_attn_impl(cfg, mt, mesh), n) for mt, n in method[0])
                attn_u = tuple((_attn_impl(cfg, mt, mesh), n) for mt, n in method[1])
            else:
                attn_d = attn_u = _attn_impl(cfg, method, mesh)

            def fresh(attn):
                def make(dev):
                    def init(a, n_layers):
                        return a.init_state(n_layers, nb, s_local, m.heads, m.head_dim, torch.float32, dev)
                    if isinstance(attn, tuple):
                        return tuple(init(a, n_l) for a, n_l in attn)
                    return init(attn, half // p.pp_degree)  # this stage's layers
                return make

            # EF caches carry across step segments, per half
            state_d = base.carry_ef_state(state_d, fresh(attn_d), self.device)
            state_u = base.carry_ef_state(state_u, fresh(attn_u), self.device)
            for i in steps:
                t = torch.full((nb,), float(self.sched.timesteps[i]), dtype=torch.float32, device=self.device)
                x = torch.cat([latents, latents], dim=0) if nb > b else latents
                out, state_d, state_u = hunyuandit_forward(
                    self.params, x.to(m.dtype), t, text, m, rope=(cos, sin), attn=attn_d,
                    attn_state_down=state_d, attn_state_up=state_u, attn_up=None if attn_d is attn_u else attn_u,
                    text_mask=text_mask, tp_axis=tp_axis, pp_stages=p.pp_degree, mesh=mesh)
                eps = out[..., : out.shape[-1] // 2]  # drop the learned-variance half
                if cfg.do_cfg:
                    eps = base.cfg_combine(eps, cfg.guidance_scale, p.cfg_degree, mesh)
                latents, dpm_state = dpm_step(self.sched, i, cfg.num_steps, latents, eps, dpm_state)
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, tokens, p*p*C) -> images (B, H, W, 3) in [0, 1]."""
        m = self.cfg.model
        hp, wp = self.cfg.grid
        lat = cm.unpatchify(latent_tokens.to(self.device), m.patch, hp, wp, m.in_channels)
        return torch.clamp(vae_decode(self.vae_params, lat, self.cfg.vae) * 0.5 + 0.5, 0.0, 1.0)
