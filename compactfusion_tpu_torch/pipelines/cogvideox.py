"""CogVideoX text-to-video pipeline (counterpart of ``compactfusion_tpu/pipelines/cogvideox.py``).

T5 states in, video out: true CFG (a doubled batch, or split over the cfg
axis), optionally CogVideoX's dynamic guidance, v-prediction DDIM on the
SNR-shifted zero-terminal-SNR schedule ("trailing" timesteps), then the
causal 3D VAE.  The text encoders run outside: the caller passes their
(2, B, S, D) [cond, uncond] states.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``), each
rank runs its share, as the JAX package's ``shard_map`` does: the text
split over cfg, the batch over dp, the video tokens over (ring, ulysses),
the text as the attention's joint front tensors; the sequence-parallel
attention plain (``USPAttn``) or compressed (``CompactUSPAttn``), fused or
not, with per-layer ``compress_func`` plans and EF caches carried across
step segments; every rank gets the whole latents back.  Each rank holds
its part of the params (``parallel/tp.py``): with ``pp_degree`` > 1 its
stage's blocks, run as sync PipeFusion (the JAX package has no patch
pipeline for CogVideoX), with ``tp_degree`` > 1 its share of the ffn of
the joined text + video stream.  CogVideoX has no VAE-rank path, as in the
JAX package: with ``vae_parallel_size`` the tail ranks (``vae_mesh=``) stay
idle and return None, and the DiT ranks decode.

Unlike the JAX config, :class:`CogVideoXPipelineConfig` names its VAE
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
from compactfusion_tpu_torch.models.cogvideox import CogVideoXConfig, cogvideox_forward, video_positions
from compactfusion_tpu_torch.models.vae3d import VAE3DConfig, cogvideox_vae, vae3d_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_TP, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import ddim_step_v, ddpm_schedule


@dataclasses.dataclass(frozen=True)
class CogVideoXPipelineConfig:
    model: CogVideoXConfig
    vae: VAE3DConfig = cogvideox_vae()
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    num_steps: int = 50
    guidance_scale: float = 6.0
    #: per-step cosine-ramped guidance: g(t) = 1 + g0 * (1 - cos(pi *
    #: ((n - t) / n)^5)) / 2 with t the raw timestep value
    use_dynamic_cfg: bool = False
    height: int = 480
    width: int = 720
    num_frames: int = 49  # pixel frames; latent frames = (n - 1) // 4 + 1

    @property
    def latent_frames(self) -> int:
        return (self.num_frames - 1) // 4 + 1

    @property
    def pad_latent_frames(self) -> int:
        """Frames that pad the latent frames to a multiple of ``patch_t``
        (CogVideoX 1.5), dropped before the decode."""
        return (-self.latent_frames) % self.model.patch_t

    @property
    def grid(self) -> Tuple[int, int, int]:
        hp = self.height // 8 // self.model.patch
        wp = self.width // 8 // self.model.patch
        ft = (self.latent_frames + self.pad_latent_frames) // self.model.patch_t
        return ft, hp, wp

    @property
    def tokens(self) -> int:
        f, hp, wp = self.grid
        return f * hp * wp

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    def __post_init__(self):
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens,
                                   depth=self.model.depth, family="cogvideox")


def _attn_impl(cfg: CogVideoXPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    p = cfg.parallel
    if cfg.compact.enabled:
        return CompactUSPAttn(cfg=cfg.compact, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


def unpack_latents(latent_tokens: torch.Tensor, cfg: CogVideoXPipelineConfig) -> torch.Tensor:
    """(B, ft*hp*wp, pt*p*p*C) tokens -> (B, T_lat, h, w, C) latent video,
    the padding frames dropped."""
    f, hp, wp = cfg.grid
    m = cfg.model
    b = latent_tokens.shape[0]
    pt, p, c = m.patch_t, m.patch, m.in_channels
    lat = latent_tokens.reshape(b, f, hp, wp, pt, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return lat.reshape(b, f * pt, hp * p, wp * p, c)[:, cfg.pad_latent_frames:]


class CogVideoXPipeline:
    """User-facing pipeline: ``CogVideoXPipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``.  With ``cfg.parallel.world_size > 1`` every
    rank builds one with its ``mesh`` (``parallel.mesh.make_mesh(cfg.
    parallel)``) and calls it with the same text and noise."""

    def __init__(self, params, vae_params, cfg: CogVideoXPipelineConfig, device="cuda",
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: CogVideoX gives it no work
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
        f, hp, wp = cfg.grid
        self.sched = ddpm_schedule(cfg.num_steps, beta_schedule="scaled_linear", snr_shift_scale=3.0,
                                   rescale_zero_snr=True, timestep_spacing="trailing")
        self.dyn_cfg = base.dynamic_cfg_table(cfg.guidance_scale, self.sched.timesteps, cfg.num_steps)
        if m.use_rotary:
            self.video_rope = cm.rope_frequencies(video_positions(f, hp, wp, self.device), m.axes_dim)
            self.pos_embed = None
        else:
            # a 2D table over (frames x rows, cols), as the JAX pipeline builds it
            self.video_rope = None
            self.pos_embed = cm.sincos_pos_embed_2d(m.dim, f * hp, wp).to(self.device)

    def __call__(self, txt, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """txt (2, B, S_txt, text_dim) = [cond, uncond] T5 states.  Noise
        comes from ``latents`` (B, tokens, token_in) when given, else from
        ``generator``.  Returns the video (B, T, H, W, 3) in [0, 1], or the
        final latent tokens when not ``decode`` or without VAE params; None
        on an idle VAE-tail rank."""
        cfg = self.cfg
        if self.tail:
            return None
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            latents = base.prepare_latents(generator, txt.shape[1], cfg.tokens, cfg.model.token_in,
                                           torch.float32, self.device)
        latents = self._sample(txt, latents)
        return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, txt, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        txt = txt.to(self.device)
        latents = latents.to(self.device, torch.float32)
        rope, pe = self.video_rope, self.pos_embed
        if mesh is not None:
            # this rank's share: the batch over dp, the tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            txt = txt[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
            if rope is not None:
                rope = tuple(base.slice_local_tokens(t, mesh, p.ulysses_degree, p.ring_degree) for t in rope)
            else:
                pe = base.slice_local_tokens(pe, mesh, p.ulysses_degree, p.ring_degree)
        cfg_split = cfg.do_cfg and p.cfg_degree == 2
        if cfg_split:
            txt = txt[mesh.axis_index(AXIS_CFG)]  # this rank's half: cond or uncond
        elif cfg.do_cfg:
            txt = torch.cat([txt[0], txt[1]], dim=0)
        else:
            txt = txt[0]
        txt = txt.to(m.dtype)
        b, s_local = latents.shape[:2]
        n_model_batch = 2 * b if cfg.do_cfg and not cfg_split else b

        attn_state = None
        for plan, steps in base.compact_layer_segments(cfg.compact, cfg.num_steps, m.depth):
            if isinstance(plan, tuple):  # per-layer compress_func plans
                attn = tuple((_attn_impl(cfg, method, mesh), n_l) for method, n_l in plan)
            else:
                attn = _attn_impl(cfg, plan, mesh)

            def fresh(dev, attn=attn):
                def init(a, n_layers):
                    return a.init_state(n_layers, n_model_batch, s_local, m.heads, m.head_dim, torch.float32, dev)
                if isinstance(attn, tuple):
                    return tuple(init(a, n_l) for a, n_l in attn)
                return init(attn, m.depth // p.pp_degree)  # this stage's layers

            attn_state = base.carry_ef_state(attn_state, fresh, self.device)  # EF caches across segments
            for i in steps:
                t = torch.full((n_model_batch,), float(self.sched.timesteps[i]), dtype=torch.float32,
                               device=self.device)
                x = torch.cat([latents, latents], dim=0) if n_model_batch > b else latents
                v, attn_state = self._forward(x.to(m.dtype), txt, t, rope, pe, attn, attn_state)
                if cfg.do_cfg:
                    g = self.dyn_cfg[i] if cfg.use_dynamic_cfg else cfg.guidance_scale
                    v = base.cfg_combine(v, g, p.cfg_degree, mesh)
                latents = ddim_step_v(self.sched, i, cfg.num_steps, latents, v)
        return base.gather_latents(latents, mesh)

    def _forward(self, x, txt, t, rope, pe, attn, attn_state):
        """One denoiser call on this rank's model batch."""
        m, p = self.cfg.model, self.cfg.parallel
        return cogvideox_forward(self.params, x, txt, t, m, video_rope=rope, pos_embed=pe, attn=attn,
                                 attn_state=attn_state, mesh=self.mesh, tp_axis=AXIS_TP if p.tp_degree > 1 else None,
                                 pp_stages=p.pp_degree)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, tokens, token_in) -> video (B, T, H, W, 3) in
        [0, 1] (the diffusers video postprocess ``(x / 2 + 0.5).clamp(0, 1)``)."""
        lat = unpack_latents(latent_tokens.to(self.device), self.cfg)
        vid = vae3d_decode(self.vae_params, lat, self.cfg.vae)
        return torch.clamp(vid * 0.5 + 0.5, 0.0, 1.0)
