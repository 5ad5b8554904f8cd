"""FLUX.1 text-to-image pipeline (counterpart of ``compactfusion_tpu/pipelines/flux.py``).

T5 states and the pooled CLIP vector go in, images come out: flow-match
Euler with FLUX's resolution-dependent dynamic shift, embedded guidance (no
CFG batch), then the 16-channel VAE decode.  The text encoders are not part
of the port yet: the caller passes their outputs.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``), each
rank runs its share, as the JAX package's ``shard_map`` does: the batch
over dp, the image tokens over (ring, ulysses), the text replicated as the
attention's joint front tensors; the sequence-parallel attention is plain
(``USPAttn``) or compressed (``CompactUSPAttn``, also with
``compact.patch_gather``, which FLUX does not route elsewhere), fused or
not (``use_fused_ring``); the cache probes sum over the (ring, ulysses)
ranks, and every rank gets the whole latents back.  Each rank holds its
part of the params (``parallel/tp.py``): with ``pp_degree`` > 1 both block
families are first padded with identity blocks (``pad_flux_for_pp``) and
each stage holds its layers of each, run as sync PipeFusion
(``num_pipeline_patch`` 1) or as the patch pipeline
(``pipelines/flux_patch_pp.py``); with ``tp_degree`` > 1 its share of every
ffn and of the single blocks' MLP.  FLUX has no VAE-rank path, as in the
JAX package: with ``vae_parallel_size`` the tail ranks (``vae_mesh=``) stay
idle and return None, and the DiT ranks decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.cache.accel import PIPEFUSION_REFUSAL, CacheAccelConfig, init_cache_state
from compactfusion_tpu_torch.config import (
    CompactConfig,
    CompressType,
    ParallelConfig,
    validate_parallel_geometry,
)
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import CompactUSPAttn, SingleDeviceAttn, USPAttn
from compactfusion_tpu_torch.models.flux import FluxConfig, flux_forward, flux_image_positions, pad_flux_for_pp
from compactfusion_tpu_torch.models.vae import VAEConfig, vae_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_RING, AXIS_TP, AXIS_ULYSSES, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.flow_match import (
    calculate_shift,
    flow_match_schedule,
    flow_match_step,
)
from compactfusion_tpu_torch.utils import collector
from compactfusion_tpu_torch.utils.prof import span


@dataclasses.dataclass(frozen=True)
class FluxPipelineConfig:
    model: FluxConfig
    vae: VAEConfig
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    cache: CacheAccelConfig = CacheAccelConfig()
    num_steps: int = 28
    guidance_scale: float = 3.5
    height: int = 1024
    width: int = 1024
    #: PipeFusion micro-patches per image (M > 1 with pp > 1: the patch
    #: pipeline, reference --num_pipeline_patch)
    num_pipeline_patch: int = 1
    #: full-sequence sync steps before patch mode
    runtime_warmup_steps: int = 1

    @property
    def grid(self) -> Tuple[int, int]:
        # the VAE's 8x downsampling, then 2x2 packing
        return self.height // 16, self.width // 16

    @property
    def tokens(self) -> int:
        hp, wp = self.grid
        return hp * wp

    def __post_init__(self):
        # no depth check: FLUX pads both block families to divide the
        # stages; M >= 2*pp keeps the patch pipeline's 2*pp virtual stages full
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens,
                                   num_pipeline_patch=self.num_pipeline_patch,
                                   patch_pp_min_factor=2, family="flux")
        if self.parallel.pp_degree > 1 and self.cache.mode != "none":
            raise ValueError(PIPEFUSION_REFUSAL)

    @property
    def patch_pipelined(self) -> bool:
        return self.parallel.pp_degree > 1 and self.num_pipeline_patch > 1


def _attn_impl(cfg: FluxPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    c, p = cfg.compact, cfg.parallel
    if c.enabled:
        return CompactUSPAttn(cfg=c, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


def unpack_latents(latent_tokens: torch.Tensor, cfg: FluxPipelineConfig) -> torch.Tensor:
    """(B, S, 64) packed tokens -> (B, H/8, W/8, 16) latent image."""
    hp, wp = cfg.grid
    return cm.unpatchify(latent_tokens, 2, hp, wp, cfg.vae.latent_channels)


def decode_latents(vae_params, latent_tokens: torch.Tensor, cfg: FluxPipelineConfig) -> torch.Tensor:
    img = vae_decode(vae_params, unpack_latents(latent_tokens, cfg), cfg.vae)
    return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)


class FluxPipeline:
    """User-facing pipeline: ``FluxPipeline(params, vae_params, cfg,
    device="cuda", mesh=None)``.  With ``cfg.parallel.world_size > 1`` every
    rank builds one with its ``mesh`` (``parallel.mesh.make_mesh(cfg.
    parallel)``) and calls it with the same text and noise."""

    def __init__(self, params, vae_params, cfg: FluxPipelineConfig, device="cuda",
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: FLUX gives it no work
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        # float32 matmuls and convolutions in full fp32 on the GPU (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        #: the model the blocks run: padded with identity blocks under pp
        self.model = cfg.model
        if cfg.parallel.pp_degree > 1 and not self.tail:
            params, self.model = pad_flux_for_pp(params, cfg.model, cfg.parallel.pp_degree)
        # this rank's stage of each block family and share of the ffns
        self.params = None if self.tail else local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        self.device = torch.device(device)
        m = cfg.model
        # FLUX overrides the scheduler's sigmas with linspace(1, 1/N, N)
        self.sched = flow_match_schedule(cfg.num_steps, use_dynamic_shifting=True,
                                         mu=calculate_shift(cfg.tokens), final_sigma=1.0 / cfg.num_steps)
        self.img_rope = cm.rope_frequencies(flux_image_positions(*cfg.grid, self.device), m.axes_dim)
        #: skipped steps of the last request (TeaCache/FBCache), else None
        self.last_skips = None

    def __call__(self, txt, pooled, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """txt (B, S_txt, text_dim) T5 states; pooled (B, pooled_dim) CLIP
        pooled embedding.  Noise comes from ``latents`` (B, tokens,
        in_channels) when given, else from ``generator``.  Returns images
        (B, H, W, 3) in [0, 1], or the final latent tokens when not
        ``decode``; None on an idle VAE-tail rank."""
        with span("request"):
            cfg = self.cfg
            if self.tail:
                return None
            if latents is None:
                if generator is None:
                    raise ValueError("pass a torch.Generator or explicit latents")
                latents = base.prepare_latents(generator, txt.shape[0], cfg.tokens, cfg.model.in_channels,
                                               torch.float32, self.device)
            if cfg.patch_pipelined:
                from compactfusion_tpu_torch.pipelines.flux_patch_pp import flux_patch_pp_sample

                latents = flux_patch_pp_sample(self, txt, pooled, latents)
            else:
                latents = self._sample(txt, pooled, latents)
            return self.decode(latents) if decode and self.vae_params is not None else latents

    @torch.inference_mode()
    def _sample(self, txt, pooled, latents):
        cfg, m, p, mesh = self.cfg, self.model, self.cfg.parallel, self.mesh
        txt = txt.to(self.device)
        pooled = pooled.to(self.device)
        latents = latents.to(self.device, torch.float32)
        cos_i, sin_i = self.img_rope
        if mesh is not None:
            # this rank's share: the batch over dp, the image tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            txt, pooled = txt[rows], pooled[rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
            cos_i, sin_i = (base.slice_local_tokens(t, mesh, p.ulysses_degree, p.ring_degree)
                            for t in (cos_i, sin_i))
        img_rope = (cos_i, sin_i)
        # text tokens all sit at position (0, 0, 0)
        txt_rope = cm.rope_frequencies(
            torch.zeros((txt.shape[1], len(m.axes_dim)), dtype=torch.int64, device=self.device), m.axes_dim)
        b, s_local = latents.shape[:2]
        guidance = (torch.full((b,), cfg.guidance_scale * 1000.0, dtype=torch.float32, device=self.device)
                    if m.guidance_embeds else None)

        use_cache = cfg.cache.mode != "none"
        # the probes sum over every sequence-parallel rank
        cache_cfg = dataclasses.replace(cfg.cache, sp_axes=(AXIS_RING, AXIS_ULYSSES) if p.sp_degree > 1 else ())
        cache_state = None
        if use_cache:
            if cfg.compact.enabled:
                raise ValueError("cache acceleration is incompatible with compact compression")
            shp = (b, s_local, m.dim)
            cache_state = init_cache_state(shp, shp, torch.float32, self.device)

        state_d = state_s = None
        segments = base.compact_two_family_segments(cfg.compact, cfg.num_steps, m.double_layers,
                                                    m.single_layers)
        for method, steps in segments:
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

            # EF caches carry across step segments, per family: a per-layer
            # plan can change one family's strategy and not the other's
            # (this stage's layers of each family under PipeFusion)
            state_d = base.carry_ef_state(state_d, fresh(attn_d, m.double_layers // p.pp_degree), self.device)
            state_s = base.carry_ef_state(state_s, fresh(attn_s, m.single_layers // p.pp_degree), self.device)
            for i in steps:
                with span("step", {"i": i}):
                    t = torch.full((b,), float(self.sched.timesteps[i]), dtype=torch.float32,
                                   device=self.device)
                    fwd = flux_forward(
                        self.params, latents.to(m.dtype), txt.to(m.dtype), pooled, t, guidance, m,
                        img_rope=img_rope, txt_rope=txt_rope, attn=attn_d, attn_state_double=state_d,
                        attn_state_single=state_s, attn_single=attn_s,
                        cache_cfg=cache_cfg if use_cache else None, cache_state=cache_state, mesh=mesh,
                        # the final step always computes
                        cache_force=i == cfg.num_steps - 1,
                        tp_axis=AXIS_TP if p.tp_degree > 1 else None, pp_stages=p.pp_degree,
                    )
                    if use_cache:
                        v, state_d, state_s, cache_state = fwd
                    else:
                        v, state_d, state_s = fwd
                    with span("scheduler"):
                        latents = flow_match_step(self.sched, i, latents, v)
                    if collector.enabled():
                        collector.collect(latents, "latents")  # per-step tap (reference pipeline_flux.py:481)
        self.last_skips = int(cache_state.skips) if use_cache else None
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> torch.Tensor:
        """Latent tokens (B, tokens, 64) -> images (B, H, W, 3) in [0, 1]."""
        with span("decode"):
            return decode_latents(self.vae_params, latent_tokens.to(self.device), self.cfg)
