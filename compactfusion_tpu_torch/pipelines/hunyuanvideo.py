"""HunyuanVideo text-to-video pipeline
(counterpart of ``compactfusion_tpu/pipelines/hunyuanvideo.py``).

Raw LLaMA states (refined inside the model) and the CLIP pooled vector in,
video out: flow-match Euler with the static shift 7 and ``final_sigma =
1/N`` (diffusers: sigmas = linspace(1, 0, N + 1)[:-1]), embedded guidance
(no CFG batch), then the HunyuanVideo causal 3D VAE on the 2x2-unpacked
latents.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``), as
the JAX package's ``shard_map`` runs it: the batch over dp, the video
tokens over (ring, ulysses), the text as the attention's joint front
tensors; the attention plain (``SingleDeviceAttn``, ``USPAttn``) or
compressed (``CompactUSPAttn``), fused or not, with per-layer plans over
the two block families and EF caches carried across step segments per
family; every rank gets the whole latents back.  With ``pp_degree`` > 1
each stage holds its share of both block families (``parallel/tp.py``;
each family's depth must divide the stages) and runs them as sync
PipeFusion; with ``tp_degree`` > 1 its share of every ffn.  HunyuanVideo
has no VAE-rank path: the tail ranks (``vae_mesh=``) stay idle and return
None, as FLUX's do.

Unlike the JAX config, :class:`HunyuanVideoPipelineConfig` names its VAE
config (``vae``), as the port's other pipelines do.
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
from compactfusion_tpu_torch.models.hunyuanvideo import (
    HunyuanVideoConfig,
    hunyuanvideo_forward,
    hunyuanvideo_positions,
)
from compactfusion_tpu_torch.models.vae3d import VAE3DConfig, hunyuanvideo_vae, hv_vae3d_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_TP, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.flow_match import flow_match_schedule, flow_match_step


@dataclasses.dataclass(frozen=True)
class HunyuanVideoPipelineConfig:
    model: HunyuanVideoConfig
    vae: VAE3DConfig = hunyuanvideo_vae()
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    num_steps: int = 50
    guidance_scale: float = 6.0
    height: int = 720
    width: int = 1280
    num_frames: int = 129
    shift: float = 7.0  # HunyuanVideo's large static flow shift

    @property
    def latent_frames(self) -> int:
        return (self.num_frames - 1) // 4 + 1

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.latent_frames, self.height // 16, self.width // 16

    @property
    def tokens(self) -> int:
        f, hp, wp = self.grid
        return f * hp * wp

    def __post_init__(self):
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens, family="hunyuanvideo")
        pp = self.parallel.pp_degree
        if pp > 1 and (self.model.double_layers % pp or self.model.single_layers % pp):
            raise ValueError("sync PipeFusion needs both block families divisible by pp_degree")


def _attn_impl(cfg: HunyuanVideoPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    p = cfg.parallel
    if cfg.compact.enabled:
        return CompactUSPAttn(cfg=cfg.compact, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


def unpack_latents(latent_tokens: torch.Tensor, cfg: HunyuanVideoPipelineConfig) -> torch.Tensor:
    """(B, f*hl*wl, 4C) 2x2-packed tokens -> (B, f, 2hl, 2wl, C) latent video."""
    f, hl, wl = cfg.grid
    b, c = latent_tokens.shape[0], cfg.model.in_channels // 4
    lat = cm.unpatchify(latent_tokens.reshape(b * f, hl * wl, -1), 2, hl, wl, c)
    return lat.reshape(b, f, 2 * hl, 2 * wl, c)


class HunyuanVideoPipeline:
    """User-facing pipeline: ``HunyuanVideoPipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``."""

    def __init__(self, params, vae_params, cfg: HunyuanVideoPipelineConfig, device="cuda",
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: HunyuanVideo gives it no work
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        # float32 matmuls and convolutions in full fp32 on the GPU (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # this rank's stage of each block family and share of the ffns
        self.params = None if self.tail else local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        self.device = torch.device(device)
        m = cfg.model
        self.sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift, final_sigma=1.0 / cfg.num_steps)
        self.video_rope = cm.rope_frequencies(hunyuanvideo_positions(*cfg.grid, self.device), m.axes_dim,
                                              theta=m.rope_theta)

    def __call__(self, txt, pooled=None, text_mask=None, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """txt (B, S, text_dim) raw LLaMA states, or (2, B, S, D) [cond,
        uncond] of which the cond half is taken; pooled (B, pooled_dim),
        zeros when None; text_mask (B, S) bool, all True when None.  Noise
        comes from ``latents`` (B, tokens, in_channels) when given, else from
        ``generator``.  Returns the video (B, T, H, W, 3) in [0, 1], or the
        final latent tokens when not ``decode`` or without VAE params; None
        on an idle VAE-tail rank."""
        cfg = self.cfg
        if self.tail:
            return None
        if txt.dim() == 4:
            txt = txt[0]
        b = txt.shape[0]
        if pooled is None:
            pooled = torch.zeros((b, cfg.model.pooled_dim), dtype=torch.float32)
        if text_mask is None:
            text_mask = torch.ones(txt.shape[:2], dtype=torch.bool)
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            latents = base.prepare_latents(generator, b, cfg.tokens, cfg.model.in_channels, torch.float32,
                                           self.device)
        latents = self._sample(txt, text_mask, pooled, latents)
        return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, txt, text_mask, pooled, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        txt, text_mask, pooled = txt.to(self.device), text_mask.to(self.device), pooled.to(self.device)
        latents = latents.to(self.device, torch.float32)
        cos_v, sin_v = self.video_rope
        if mesh is not None:
            # this rank's share: the batch over dp, the video tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            txt, text_mask, pooled = txt[rows], text_mask[rows], pooled[rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
            cos_v, sin_v = (base.slice_local_tokens(t, mesh, p.ulysses_degree, p.ring_degree) for t in (cos_v, sin_v))
        # text tokens all sit at position (0, 0, 0)
        txt_rope = cm.rope_frequencies(torch.zeros((txt.shape[1], len(m.axes_dim)), dtype=torch.int64,
                                                   device=self.device), m.axes_dim, theta=m.rope_theta)
        b, s_local = latents.shape[:2]
        guidance = (torch.full((b,), cfg.guidance_scale * 1000.0, dtype=torch.float32, device=self.device)
                    if m.guidance_embeds else None)
        txt = txt.to(m.dtype)

        state_d = state_s = None
        for method, steps in base.compact_two_family_segments(cfg.compact, cfg.num_steps, m.double_layers,
                                                              m.single_layers):
            if isinstance(method, tuple):  # per-layer (double, single) plans
                attn_d = tuple((_attn_impl(cfg, mt, mesh), n) for mt, n in method[0])
                attn_s = tuple((_attn_impl(cfg, mt, mesh), n) for mt, n in method[1])
            else:
                attn_d = attn_s = _attn_impl(cfg, method, mesh)

            def fresh(attn, depth):
                def make(dev):
                    def init(a, n_layers):
                        return a.init_state(n_layers, b, s_local, m.heads, m.head_dim, torch.float32, dev)
                    if isinstance(attn, tuple):
                        return tuple(init(a, n_l) for a, n_l in attn)
                    return init(attn, depth)
                return make

            # EF caches carry across step segments, per family (this stage's
            # layers of each family under PipeFusion)
            state_d = base.carry_ef_state(state_d, fresh(attn_d, m.double_layers // p.pp_degree), self.device)
            state_s = base.carry_ef_state(state_s, fresh(attn_s, m.single_layers // p.pp_degree), self.device)
            for i in steps:
                t = torch.full((b,), float(self.sched.timesteps[i]), dtype=torch.float32, device=self.device)
                v, state_d, state_s = hunyuanvideo_forward(
                    self.params, latents.to(m.dtype), txt, pooled, t, guidance, m, video_rope=(cos_v, sin_v),
                    txt_rope=txt_rope, text_mask=text_mask, attn=attn_d, attn_state_double=state_d,
                    attn_state_single=state_s, attn_single=attn_s, mesh=mesh,
                    tp_axis=AXIS_TP if p.tp_degree > 1 else None, pp_stages=p.pp_degree)
                latents = flow_match_step(self.sched, i, latents, v)
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, tokens, 64) -> video (B, T, H, W, 3) in [0, 1]."""
        vid = hv_vae3d_decode(self.vae_params, unpack_latents(latent_tokens.to(self.device), self.cfg), self.cfg.vae)
        return torch.clamp(vid * 0.5 + 0.5, 0.0, 1.0)
