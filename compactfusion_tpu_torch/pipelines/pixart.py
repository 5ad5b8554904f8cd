"""PixArt-alpha text-to-image pipeline
(counterpart of ``compactfusion_tpu/pipelines/pixart.py``).

CFG as a doubled batch (or split over the cfg axis), 20-step DPM-Solver++
2M on the "linspace" timestep table, then the VAE decode.  With
``CompactConfig(enabled=True, simulate_ring=R)`` every self-attention runs
the single-device compressed-ring emulation (``SimRingAttn``); its EF
caches carry from the warmup steps into the compressed steps.  A per-layer
``compress_func`` plan runs one strategy per contiguous layer segment,
each with its own EF state.  The single-device accelerators run with
compression off: DiTFastAttn (``fast_attn_plan``, a (steps, depth) table of
``FastAttnMethod`` values) and TeaCache/FBCache (``cache``).

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``),
each rank runs its share, as the JAX package's ``shard_map`` does: the text
split over cfg, the batch over dp, the tokens over (ring, ulysses), the
sequence-parallel attention plain (``USPAttn``) or compressed
(``CompactUSPAttn``), fused or not (``use_fused_ring``), or, with
``compact.patch_gather``, the patch-parallel gather (``PatchParallelAttn``:
sync, compressed, or DistriFusion's stale gather with ``patch_async``);
the cache probes sum over the (ring, ulysses) ranks; every rank gets the
whole latents back.  Each rank holds its part of the params
(``parallel/tp.py``): with ``pp_degree`` > 1 its stage's blocks, run as
sync PipeFusion (``num_pipeline_patch`` 1) or as the patch pipeline
(``pipelines/pixart_patch_pp.py``, M > 1 patches after
``runtime_warmup_steps`` sync steps); with ``tp_degree`` > 1 its share of
every ffn.  With ``vae_parallel_size`` the VAE ranks (``vae_mesh=``, from
``parallel.mesh.make_vae_mesh``) skip the denoise and decode in height
bands (``parallel/vae.py``); the image reaches rank 0, and the other ranks
return None.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.cache.accel import CacheAccelConfig, init_cache_state
from compactfusion_tpu_torch.cache.fast_attn import FastAttnAttn, optimize_plan
from compactfusion_tpu_torch.config import (
    CompactConfig,
    CompressType,
    ParallelConfig,
    validate_parallel_geometry,
)
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import (
    CompactUSPAttn,
    SimRingAttn,
    SingleDeviceAttn,
    USPAttn,
)
from compactfusion_tpu_torch.models.pixart import PixArtConfig, pixart_forward, precompute_text_kv
from compactfusion_tpu_torch.models.vae import VAEConfig, vae_decode
from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_RING, AXIS_TP, AXIS_ULYSSES, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.patch import PatchParallelAttn
from compactfusion_tpu_torch.parallel.tp import local_params
from compactfusion_tpu_torch.parallel.vae import decode_on_vae_ranks, recv_from_vae_ranks, send_to_vae_ranks
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import ddpm_schedule, dpm_init_state, dpm_step
from compactfusion_tpu_torch.utils import collector


@dataclasses.dataclass(frozen=True)
class PixArtPipelineConfig:
    model: PixArtConfig
    vae: VAEConfig
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    cache: CacheAccelConfig = CacheAccelConfig()
    #: DiTFastAttn per-(step, layer) method plan as a tuple-of-tuples of ints
    #: (FastAttnMethod values), shape (num_steps, depth); None = off.
    fast_attn_plan: Optional[tuple] = None
    #: DiTFastAttn window size
    fast_attn_window: int = 64
    num_steps: int = 20
    #: PipeFusion micro-patches per image (M > 1 with pp > 1: the
    #: patch-pipelined path, reference --num_pipeline_patch)
    num_pipeline_patch: int = 1
    #: full-sequence sync steps before patch mode (reference --warmup_steps)
    runtime_warmup_steps: int = 1
    guidance_scale: float = 4.5
    height: int = 512
    width: int = 512

    @property
    def latent_hw(self) -> Tuple[int, int]:
        return self.height // 8, self.width // 8

    @property
    def grid(self) -> Tuple[int, int]:
        lh, lw = self.latent_hw
        return lh // self.model.patch, lw // self.model.patch

    @property
    def tokens(self) -> int:
        hp, wp = self.grid
        return hp * wp

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    def __post_init__(self):
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens,
                                   depth=self.model.depth, num_pipeline_patch=self.num_pipeline_patch,
                                   family="pixart")

    @property
    def patch_pipelined(self) -> bool:
        return self.parallel.pp_degree > 1 and self.num_pipeline_patch > 1


def _attn_impl(cfg: PixArtPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    c, p = cfg.compact, cfg.parallel
    if cfg.fast_attn_plan is not None:
        assert p.sp_degree == 1, "DiTFastAttn window bands do not shard"
        assert not c.enabled
        # batch-doubled CFG rows [cond; uncond] enable the CFG_SHARE methods
        return FastAttnAttn(window_size=cfg.fast_attn_window,
                            cfg_batched=cfg.do_cfg and cfg.parallel.cfg_degree == 1)
    if c.enabled and c.patch_gather:
        # patches live on the ring axis, so ulysses must be 1
        assert p.ulysses_degree == 1, "patch_gather requires ulysses_degree=1"
        if c.patch_async:
            mode = "async"
        elif c.compress_type != CompressType.IDENTITY:
            mode = "compact"
        else:
            mode = "sync"
        return PatchParallelAttn(cfg=c, method=method, mode=mode, mesh=mesh)
    if c.enabled and c.simulate_ring > 0:
        assert p.sp_degree == 1, "simulate_ring runs on a single device"
        return SimRingAttn(cfg=c, method=method, ring_size=c.simulate_ring)
    if c.enabled:
        return CompactUSPAttn(cfg=c, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


def _plan_table(cfg: PixArtPipelineConfig):
    """The optimized DiTFastAttn table of ``cfg`` (host integers), or None:
    FULL -> FULL_NO_RESIDUAL where no later step reads the cached residual
    (skips the residual-refresh window pass)."""
    if cfg.fast_attn_plan is None:
        return None
    table = optimize_plan(cfg.fast_attn_plan)
    if table.shape != (cfg.num_steps, cfg.model.depth):
        raise ValueError(f"fast_attn_plan is {table.shape}, expected {(cfg.num_steps, cfg.model.depth)}")
    return table


class PixArtPipeline:
    """User-facing pipeline: ``PixArtPipeline(params, vae_params, cfg,
    device, mesh=None)``.  With ``cfg.parallel.world_size > 1`` every rank
    builds one with its ``mesh`` (``parallel.mesh.make_mesh(cfg.parallel)``)
    and calls it with the same text and noise."""

    def __init__(self, params, vae_params, cfg: PixArtPipelineConfig, device,
                 mesh: Optional[Mesh] = None, vae_mesh: Optional[Mesh] = None):
        if cfg.parallel.vae_parallel_size and vae_mesh is None:
            raise ValueError(f"{cfg.parallel} has VAE ranks: pass the VAE mesh (make_vae_mesh)")
        #: a VAE rank skips the denoise and decodes its band
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        # float32 matmuls and convolutions in full fp32 on the GPU: cuDNN
        # convolutions default to TF32, which keeps ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # this rank's stage of the blocks and share of the ffns
        self.params = None if self.tail else local_params(params, mesh)
        self.vae_params = vae_params
        self.cfg = cfg
        self.device = torch.device(device)
        hp, wp = cfg.grid
        self.pos_embed = cm.sincos_pos_embed_2d(
            cfg.model.dim, hp, wp, base_size=cfg.model.base_size,
            interpolation_scale=cfg.model.interpolation_scale,
        ).to(self.device)
        self.sched = ddpm_schedule(cfg.num_steps, timestep_spacing="linspace")
        self.plan_table = _plan_table(cfg)
        #: skipped steps of the last request (TeaCache/FBCache), else None
        self.last_skips = None

    def with_fast_attn(self, plan, window: int) -> "PixArtPipeline":
        """This pipeline, on this rank's weights as they are, running the
        DiTFastAttn ``plan`` ((steps, depth) method ids) with ``window``.  A
        new pipeline from ``self.params`` would cut a tp or pp rank's share
        a second time."""
        new = copy.copy(self)
        new.cfg = dataclasses.replace(self.cfg, fast_attn_plan=tuple(tuple(int(m) for m in row) for row in plan),
                                      fast_attn_window=window)
        new.plan_table = _plan_table(new.cfg)
        return new

    def __call__(self, text, text_mask, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, decode: bool = True):
        """text (2, B, S_text, text_dim) = [cond, uncond]; text_mask (2, B,
        S_text) bool or None.  Noise comes from ``latents`` (B, tokens,
        p*p*C) when given, else from ``generator``.  Returns images
        (B, H, W, 3) in [0, 1], or the final latent tokens when not
        ``decode``.  With VAE ranks the images reach rank 0 alone: a VAE
        rank, and any other rank, returns None when decoding."""
        cfg = self.cfg
        if self.tail:
            if decode:
                self.decode_band(text.shape[1])
            return None
        if text_mask is None:
            text_mask = torch.ones(text.shape[:3], dtype=torch.bool)
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            m = cfg.model
            latents = base.prepare_latents(generator, text.shape[1], cfg.tokens,
                                           m.patch * m.patch * m.in_channels,
                                           torch.float32, self.device)
        if cfg.patch_pipelined:
            from compactfusion_tpu_torch.pipelines.pixart_patch_pp import patch_pp_sample

            latents = patch_pp_sample(self, text, text_mask, latents)
        else:
            latents = self._sample(text, text_mask, latents)
        return self.decode(latents) if decode else latents

    @torch.inference_mode()
    def _sample(self, text, text_mask, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        text = text.to(self.device)
        text_mask = text_mask.to(self.device)
        latents = latents.to(self.device, torch.float32)
        if mesh is not None:
            # this rank's share: the batch over dp, the tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            text, text_mask = text[:, rows], text_mask[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree,
                                              p.ring_degree, dim=1)
        cfg_split = cfg.do_cfg and p.cfg_degree == 2
        if cfg_split:
            i = mesh.axis_index(AXIS_CFG)  # this rank's half: cond or uncond
            text, text_mask = text[i], text_mask[i]
        elif cfg.do_cfg:
            text = torch.cat([text[0], text[1]], dim=0)
            text_mask = torch.cat([text_mask[0], text_mask[1]], dim=0)
        else:
            text, text_mask = text[0], text_mask[0]
        b, s_local = latents.shape[:2]
        n_model_batch = 2 * b if cfg.do_cfg and not cfg_split else b
        pos_embed = base.slice_local_tokens(self.pos_embed, mesh, p.ulysses_degree, p.ring_degree)

        dpm_state = dpm_init_state(latents.shape, self.device)
        use_cache = cfg.cache.mode != "none"
        # the probes sum over every sequence-parallel rank
        cache_cfg = dataclasses.replace(cfg.cache, sp_axes=(AXIS_RING, AXIS_ULYSSES) if p.sp_degree > 1 else ())
        cache_state = None
        if use_cache:
            if cfg.compact.enabled:
                raise ValueError("cache acceleration is incompatible with compact compression")
            shp = (n_model_batch, s_local, m.dim)
            cache_state = init_cache_state(shp, shp, torch.float32, self.device)
        # the text path is step-invariant: caption MLP + every block's
        # cross K/V once per image, kept in the model dtype
        text_kv = precompute_text_kv(self.params, text).to(m.dtype)
        tp_axis = AXIS_TP if p.tp_degree > 1 else None
        attn_state = None
        for plan, steps in base.compact_layer_segments(cfg.compact, cfg.num_steps, m.depth):
            if isinstance(plan, tuple) and len(plan) > 1:
                # per-layer plan: one strategy and one EF state per layer segment
                assert not use_cache and p.pp_degree == 1, "per-layer compression plans compose with SP/CFG/DP only"
                attn = tuple((_attn_impl(cfg, method, mesh), n_l) for method, n_l in plan)
            else:
                attn = _attn_impl(cfg, plan[0][0] if isinstance(plan, tuple) else plan, mesh)

            def fresh(dev, attn=attn):
                def init(a, n_layers):
                    return a.init_state(n_layers, n_model_batch, s_local, m.heads, m.head_dim,
                                        torch.float32, dev)
                if isinstance(attn, tuple):
                    return tuple(init(a, n_l) for a, n_l in attn)
                return init(attn, m.depth // p.pp_degree)  # this stage's layers

            attn_state = base.carry_ef_state(attn_state, fresh, self.device)
            for i in steps:
                t = torch.full((n_model_batch,), float(self.sched.timesteps[i]),
                               dtype=torch.float32, device=self.device)
                x = torch.cat([latents, latents], dim=0) if n_model_batch > b else latents
                if self.plan_table is not None:
                    attn_state["method"].copy_(torch.from_numpy(self.plan_table[i]))
                fwd = pixart_forward(
                    self.params, x.to(m.dtype), t, None, m, pos_embed=pos_embed,
                    attn=attn, attn_state=attn_state, text_mask=text_mask, text_kv=text_kv,
                    cache_cfg=cache_cfg if use_cache else None, cache_state=cache_state, mesh=mesh,
                    # the final, quality-critical step always computes
                    cache_force=i == cfg.num_steps - 1, tp_axis=tp_axis, pp_stages=p.pp_degree,
                )
                if use_cache:
                    out, attn_state, cache_state = fwd
                else:
                    out, attn_state = fwd
                eps = out[..., : out.shape[-1] // 2]  # drop the learned-variance half
                if cfg.do_cfg:
                    eps = base.cfg_combine(eps, cfg.guidance_scale, p.cfg_degree, mesh)
                latents, dpm_state = dpm_step(self.sched, i, cfg.num_steps, latents, eps, dpm_state)
                if collector.enabled():
                    collector.collect(latents, "latents")  # per-step tap (reference pipeline_flux.py:481)
        self.last_skips = int(cache_state.skips) if use_cache else None
        return base.gather_latents(latents, mesh)

    @torch.inference_mode()
    def decode_band(self, batch: int) -> None:
        """On a VAE rank: wait for the latents of ``batch`` images from rank
        0, decode this rank's band and hand the image back
        (``parallel/vae.py``)."""
        m = self.cfg.model
        hp, wp = self.cfg.grid
        decode_on_vae_ranks(self.vae_params, (batch, hp * m.patch, wp * m.patch, m.in_channels), self.cfg.vae,
                            self.vae_mesh, self.device)

    @torch.inference_mode()
    def decode(self, latent_tokens: torch.Tensor) -> Optional[torch.Tensor]:
        """Latent tokens (B, tokens, p*p*C) -> images (B, H, W, 3) in [0, 1].
        With VAE ranks, rank 0 hands the latents to them and receives the
        image; the other DiT ranks return None."""
        m = self.cfg.model
        hp, wp = self.cfg.grid
        lat = cm.unpatchify(latent_tokens.to(self.device), m.patch, hp, wp, m.in_channels)
        if self.vae_mesh is None:
            img = vae_decode(self.vae_params, lat, self.cfg.vae)
        elif self.vae_mesh.rank == 0:
            send_to_vae_ranks(lat, self.vae_mesh)
            b, h, w, _ = lat.shape
            up = self.cfg.vae.upscale_factor
            img = recv_from_vae_ranks((b, h * up, w * up, self.cfg.vae.out_channels), self.cfg.vae,
                                      self.vae_mesh, self.device)
        else:
            return None
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
