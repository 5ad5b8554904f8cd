"""Step-Video-T2V pipeline (counterpart of ``compactfusion_tpu/pipelines/stepvideo.py``).

Text states in, latents out: true CFG (a doubled batch, or split over the
cfg axis), flow-match Euler with Step-Video's shift 13 and ``final_sigma =
1/N``.  Step-Video's 16 x 16 x 8 video VAE is not part of the JAX package,
so, as there, the pipeline returns the final latent tokens (B, S, 64) and
accepts ``decode`` only to ignore it.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of ``cfg.parallel``), as
the JAX package's ``shard_map`` runs it: the text split over cfg, the batch
over dp, the video tokens over (ring, ulysses); every attention projection
and the ffn split over tp (``parallel/tp.py::stepvideo_local_params``),
Ulysses splitting each tp rank's heads further; the sequence-parallel
attention plain (``USPAttn``) or compressed (``CompactUSPAttn``), fused or
not, with per-layer ``compress_func`` plans and EF caches carried across
step segments, sized at ``heads / (tp * ulysses) * ulysses`` heads.  pp
ranks each run the whole model (the JAX specs replicate the blocks over
pp); VAE-tail ranks (``vae_mesh=``) stay idle and return None.  Every rank
gets the whole latents back.
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
from compactfusion_tpu_torch.models.attn_impl import CompactUSPAttn, SingleDeviceAttn, USPAttn
from compactfusion_tpu_torch.models.stepvideo import StepVideoConfig, stepvideo_forward, stepvideo_rope_tables
from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_TP, AXIS_VAE, Mesh
from compactfusion_tpu_torch.parallel.tp import stepvideo_local_params
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.flow_match import flow_match_schedule, flow_match_step


@dataclasses.dataclass(frozen=True)
class StepVideoPipelineConfig:
    model: StepVideoConfig
    parallel: ParallelConfig = ParallelConfig()
    compact: CompactConfig = CompactConfig()
    num_steps: int = 50
    guidance_scale: float = 9.0
    shift: float = 13.0  # Step-Video's large flow-match time shift
    height: int = 544
    width: int = 992
    num_frames: int = 204  # pixel frames; latent frames = n // 17 * 3

    @property
    def latent_frames(self) -> int:
        # the Step-Video VAE: 17 frames -> 3 latent frames
        return max(1, self.num_frames // 17 * 3)

    @property
    def grid(self) -> Tuple[int, int, int]:
        hp = self.height // 16 // self.model.patch
        wp = self.width // 16 // self.model.patch
        return self.latent_frames, hp, wp

    @property
    def tokens(self) -> int:
        f, hp, wp = self.grid
        return f * hp * wp

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    def __post_init__(self):
        # TP shards the attention heads on top of the Ulysses scatter
        validate_parallel_geometry(self.parallel, heads=self.model.heads, tokens=self.tokens, depth=self.model.depth,
                                   tp_shards_heads=True, family="stepvideo")


def _attn_impl(cfg: StepVideoPipelineConfig, method: Optional[CompressType], mesh: Optional[Mesh]):
    p = cfg.parallel
    if cfg.compact.enabled:
        return CompactUSPAttn(cfg=cfg.compact, method=method, mesh=mesh, ulysses_size=p.ulysses_degree,
                              fused_ring=p.use_fused_ring)
    if p.sp_degree > 1:
        return USPAttn(mesh=mesh, ulysses_size=p.ulysses_degree, fused_ring=p.use_fused_ring)
    return SingleDeviceAttn()


class StepVideoPipeline:
    """User-facing pipeline: ``StepVideoPipeline(params, cfg, device="cuda",
    mesh=None)``.  With ``cfg.parallel.world_size > 1`` every rank builds
    one with its ``mesh`` (``parallel.mesh.make_mesh(cfg.parallel)``) and the
    full tree, cuts its share and calls it with the same text and noise."""

    def __init__(self, params, cfg: StepVideoPipelineConfig, device="cuda", mesh: Optional[Mesh] = None,
                 vae_mesh: Optional[Mesh] = None):
        #: a rank of the VAE tail: Step-Video gives it no work
        self.tail = vae_mesh is not None and vae_mesh.axis_index(AXIS_VAE) >= 0
        if cfg.parallel.world_size > 1 and mesh is None and not self.tail:
            raise ValueError(f"{cfg.parallel} runs across ranks: pass this rank's mesh")
        if mesh is not None and mesh.parallel != cfg.parallel:
            raise ValueError(f"mesh of {mesh.parallel} for a pipeline of {cfg.parallel}")
        # float32 matmuls in full fp32 on the GPU (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # this rank's heads of every attention projection and share of the ffns
        self.params = None if self.tail else stepvideo_local_params(params, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.vae_mesh = vae_mesh
        self.device = torch.device(device)
        # Step-Video's FlowMatchDiscreteScheduler: sigmas = linspace(1, 0, N + 1)[:-1]
        self.sched = flow_match_schedule(cfg.num_steps, shift=cfg.shift, final_sigma=1.0 / cfg.num_steps)
        self.video_rope = stepvideo_rope_tables(*cfg.grid, cfg.model.axes_dim, device=self.device)

    def __call__(self, txt, generator: Optional[torch.Generator] = None, latents: Optional[torch.Tensor] = None,
                 decode: Optional[bool] = None):
        """txt (2, B, S_txt, text_dim) = [cond, uncond] states.  Noise comes
        from ``latents`` (B, tokens, in_channels) when given, else from
        ``generator``.  Returns the final latent tokens (B, tokens,
        in_channels) fp32 (``decode`` is ignored: no VAE); None on an idle
        VAE-tail rank."""
        cfg = self.cfg
        if self.tail:
            return None
        if latents is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or explicit latents")
            latents = base.prepare_latents(generator, txt.shape[1], cfg.tokens, cfg.model.in_channels,
                                           torch.float32, self.device)
        return self._sample(txt, latents)

    @torch.inference_mode()
    def _sample(self, txt, latents):
        cfg, m, p, mesh = self.cfg, self.cfg.model, self.cfg.parallel, self.mesh
        txt = txt.to(self.device)
        latents = latents.to(self.device, torch.float32)
        rope = self.video_rope
        if mesh is not None:
            # this rank's share: the batch over dp, the tokens over (ring, ulysses)
            b_local = latents.shape[0] // p.dp_degree
            rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
            txt = txt[:, rows]
            latents = base.slice_local_tokens(latents[rows], mesh, p.ulysses_degree, p.ring_degree, dim=1)
            rope = [tuple(base.slice_local_tokens(t, mesh, p.ulysses_degree, p.ring_degree) for t in pair)
                    for pair in rope]
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
        # the EF caches hold this rank's heads: heads / tp, of which Ulysses
        # takes its share inside the strategy
        heads = m.heads // p.tp_degree
        tp_axis = AXIS_TP if p.tp_degree > 1 else None

        attn_state = None
        for plan, steps in base.compact_layer_segments(cfg.compact, cfg.num_steps, m.depth):
            if isinstance(plan, tuple):  # per-layer compress_func plans
                attn = tuple((_attn_impl(cfg, method, mesh), n_l) for method, n_l in plan)
            else:
                attn = _attn_impl(cfg, plan, mesh)

            def fresh(dev, attn=attn):
                def init(a, n_layers):
                    return a.init_state(n_layers, n_model_batch, s_local, heads, m.head_dim, torch.float32, dev)
                if isinstance(attn, tuple):
                    return tuple(init(a, n_l) for a, n_l in attn)
                return init(attn, m.depth)

            attn_state = base.carry_ef_state(attn_state, fresh, self.device)  # EF caches across segments
            for i in steps:
                t = torch.full((n_model_batch,), float(self.sched.timesteps[i]), dtype=torch.float32,
                               device=self.device)
                x = torch.cat([latents, latents], dim=0) if n_model_batch > b else latents
                v, attn_state = stepvideo_forward(self.params, x.to(m.dtype), txt, t, m, video_rope=rope, attn=attn,
                                                  attn_state=attn_state, tp_axis=tp_axis, mesh=mesh)
                if cfg.do_cfg:
                    v = base.cfg_combine(v, cfg.guidance_scale, p.cfg_degree, mesh)
                latents = flow_match_step(self.sched, i, latents, v)
        return base.gather_latents(latents, mesh)
