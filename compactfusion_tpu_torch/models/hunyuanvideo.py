"""HunyuanVideo backbone: dual-stream MMDiT and token refiner
(counterpart of ``compactfusion_tpu/models/hunyuanvideo.py``).

  * 20 double (FLUX-style MMDiT) blocks over [text, video] and 40 single
    blocks on the fused sequence: the block math is FLUX's, so the loops
    are ``models/flux.py``'s ``flux_double_scan`` / ``flux_single_scan`` /
    ``flux_head``;
  * 3-axis RoPE over (t, h, w) with theta 256;
  * a token refiner that makes the text stream from the raw LLaMA states:
    2 self-attention blocks gated by an AdaNorm of (timestep + the masked
    mean of the text) (diffusers ``HunyuanVideoTokenRefiner``); its
    attention takes the outer AND of the token mask (position 0 always
    attends) through the masked math path (``ops/attention.attn_with_lse``);
  * CLIP pooled and guidance embedded into the timestep conditioning, as in
    FLUX.1-dev.

Under sync PipeFusion both block families are sharded over the pp stages
(the refiner and the embedders stay whole on every stage): the doubles run
as one pipeline, then the singles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.models.flux import (
    FluxConfig,
    flux_double_scan,
    flux_head,
    flux_single_scan,
    flux_time_embed,
    init_flux,
)
from compactfusion_tpu_torch.models.cogvideox import video_positions
from compactfusion_tpu_torch.ops.attention import attn_with_lse
from compactfusion_tpu_torch.parallel.pipefusion import pipefusion_blocks
from compactfusion_tpu_torch.utils.prof import span


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig(FluxConfig):
    refiner_layers: int = 2
    rope_theta: float = 256.0


def hunyuanvideo_config() -> HunyuanVideoConfig:
    """HunyuanVideo-T2V 720p: 20 double + 40 single blocks, 24 heads x 128."""
    return HunyuanVideoConfig(dim=3072, double_layers=20, single_layers=40, heads=24,
                              in_channels=64,  # a 1x2x2-packed 16-channel latent per frame
                              text_dim=4096,  # LLaMA hidden states (before the refiner)
                              pooled_dim=768,  # CLIP-L pooled
                              axes_dim=(16, 56, 56), guidance_embeds=True)


def hunyuanvideo_tiny() -> HunyuanVideoConfig:
    return HunyuanVideoConfig(dim=64, double_layers=2, single_layers=2, heads=4, in_channels=16, text_dim=32,
                              pooled_dim=16, axes_dim=(8, 4, 4), refiner_layers=2)


def hunyuanvideo_positions(frames: int, hp: int, wp: int, device=None) -> torch.Tensor:
    """(frames*hp*wp, 3) int64 (t, row, col) ids of the video token grid."""
    return video_positions(frames, hp, wp, device)


def init_hunyuanvideo(generator: torch.Generator, cfg: HunyuanVideoConfig):
    """Random init on the generator's device: ``init_flux``'s tree without
    ``context_embedder`` (the refiner makes the text stream) and with the
    refiner, its blocks stacked on a leading axis, as the JAX
    ``init_hunyuanvideo`` builds it."""
    d, dt, dev, L = cfg.dim, cfg.dtype, generator.device, (cfg.refiner_layers,)
    p = init_flux(generator, cfg)
    del p["context_embedder"]
    p["refiner"] = {
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "c_embed": {"fc1": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
                    "fc2": cm.init_linear(generator, d, d, dtype=dt)},
        "proj_in": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        "blocks": {
            "norm1": cm.init_layernorm(d, dt, dev, L),
            "attn_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
            "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
            "norm2": cm.init_layernorm(d, dt, dev, L),
            # FeedForward(activation_fn="linear-silu"): fc1 -> silu -> fc2
            "ffn": cm.init_ffn(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
            # HunyuanVideoAdaNorm: linear(silu(temb)) -> (gate_attn, gate_ff)
            "ada": cm.init_linear(generator, d, 2 * d, dtype=dt, stack=L),
        },
    }
    return p


def token_refiner(params, text: torch.Tensor, t: torch.Tensor, cfg: HunyuanVideoConfig,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw LLaMA states (B, S, text_dim) -> refined (B, S, dim).

    The conditioning is the timestep embedding plus the silu-projected
    masked mean of the text; each block gates its attention and FFN with an
    AdaNorm of it; the attention mask is the outer AND of the token mask,
    position 0 always attended."""
    h = cfg.heads
    b, s, _ = text.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=text.device)
    m = mask.to(torch.float32)
    pooled = (text.float() * m[..., None]).sum(dim=1) / (m.sum(dim=1, keepdim=True) + 1e-6)
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    temb = temb + cm.linear(params["c_embed"]["fc2"],
                            cm.silu(cm.linear(params["c_embed"]["fc1"], pooled.to(cfg.dtype))))
    x = cm.linear(params["proj_in"], text)
    attn_mask = mask[:, None, :, None] & mask[:, None, None, :]
    attn_mask[:, :, :, 0] = True
    blocks = params["blocks"]
    for l in range(cm.weight_shape(blocks["attn_qkv"])[0]):
        p = cm.layer_of(blocks, l)
        g_attn, g_ff = cm.linear(p["ada"], cm.silu(temb))[:, None, :].chunk(2, dim=-1)
        xn = cm.layernorm(p["norm1"], x, eps=1e-6)
        q, k, v = (y.reshape(b, s, h, cfg.dim // h) for y in cm.linear(p["attn_qkv"], xn).chunk(3, dim=-1))
        o = _masked_sdpa(q, k, v, attn_mask)
        x = x + g_attn * cm.linear(p["attn_out"], o.reshape(b, s, cfg.dim))
        xn = cm.layernorm(p["norm2"], x, eps=1e-6)
        x = x + g_ff * cm.ffn(p["ffn"], xn, act=cm.silu)
    return x


def _masked_sdpa(q, k, v, mask):
    """(B, S, H, D) attention with a (B, 1, Sq, Sk) bool mask, fp32 scores
    and PV, the output in q's dtype (the JAX ``_masked_sdpa``).  Every row
    attends at least position 0, so no row is dead."""
    out, _ = attn_with_lse(q.float(), k.float(), v.float(), mask=mask)
    return out.to(q.dtype)


def hunyuanvideo_forward(
    params,
    video: torch.Tensor,
    txt: torch.Tensor,
    pooled: torch.Tensor,
    t: torch.Tensor,
    guidance: Optional[torch.Tensor],
    cfg: HunyuanVideoConfig,
    *,
    video_rope: Tuple[torch.Tensor, torch.Tensor],
    txt_rope: Tuple[torch.Tensor, torch.Tensor],
    text_mask: Optional[torch.Tensor] = None,
    attn=SingleDeviceAttn(),
    attn_state_double=(),
    attn_state_single=(),
    attn_single=None,
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    mesh=None,
):
    """HunyuanVideo denoiser on this rank's video tokens.

    video (B, S_local, 64) packed latent tokens; txt (B, S_txt, text_dim)
    the raw LLaMA states (refined here); pooled (B, 768); t and guidance
    (B,) in train units.  ``attn_single`` is the single family's strategy
    (default ``attn``).  Returns (velocity, state_double, state_single)."""
    if (pp_stages > 1 or tp_axis is not None) and mesh is None:
        raise ValueError(f"PipeFusion ({pp_stages} stages) or TP ({tp_axis}) needs this rank's mesh")
    with span("embed"):
        img = cm.linear(params["x_embedder"], video)
        temb = flux_time_embed(params, pooled, t, guidance, cfg)
    with span("refiner"):
        txt = token_refiner(params["refiner"], txt.to(cfg.dtype), t, cfg, mask=text_mask)
    rope = dict(img_rope=video_rope, txt_rope=txt_rope, tp_axis=tp_axis, mesh=mesh)
    attn_s = attn if attn_single is None else attn_single
    if pp_stages > 1:
        if isinstance(attn, (tuple, list)) or attn_s is not attn:
            raise ValueError("per-layer compression plans do not compose with pp")

        def doubles(hh):
            return flux_double_scan(params["double_blocks"], *hh, temb, cfg, attn=attn,
                                    attn_state=attn_state_double, **rope)[:2]

        def singles(hh):
            return flux_single_scan(params["single_blocks"], *hh, temb, cfg, attn=attn,
                                    attn_state=attn_state_single, **rope)[:2]

        img, txt = pipefusion_blocks(doubles, (img, txt), mesh)
        img, txt = pipefusion_blocks(singles, (img, txt), mesh)
        return flux_head(params, img, temb, cfg), attn_state_double, attn_state_single

    img, txt, sd = flux_double_scan(params["double_blocks"], img, txt, temb, cfg, attn=attn,
                                    attn_state=attn_state_double, **rope)
    img, txt, ss = flux_single_scan(params["single_blocks"], img, txt, temb, cfg, attn=attn_s,
                                    attn_state=attn_state_single, **rope)
    return flux_head(params, img, temb, cfg), sd, ss
