"""Stable Diffusion 3 MMDiT (counterpart of ``compactfusion_tpu/models/sd3.py``).

Joint transformer blocks with separate image and text streams, joined for
one attention (the text as the joint K/V in front of the image rows), no
rope: a center-cropped 2D sin-cos table on the image tokens
(``common.cropped_pos_embed_2d``); AdaLN-Zero modulation from timestep +
pooled-CLIP embeddings; a flow-matching velocity head.  SD3.5 variants add
a per-head RMSNorm on q and k (``qk_norm``).  Block parameters are stacked
on a leading layer axis and the forward is a Python loop over it.

The real SD3 checkpoint's last block is ``context_pre_only`` (no text
out-projection or text FFN).  As in the JAX package the blocks run
symmetric and the converter zero-fills the missing tensors
(``io/hf.py::convert_sd3``): the last block's text outputs are computed and
never read.

Under sequence parallelism the image tokens are this rank's shard and the
text rides as the strategy's joint front tensors; under sync PipeFusion the
stack is this stage's layers (``parallel/tp.py``) and the (image, text)
pair hops stage to stage; under tensor parallelism both streams' ffns sum
over the tp axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.parallel.pipefusion import pipefusion_blocks


@dataclasses.dataclass(frozen=True)
class SD3Config:
    dim: int = 1536
    depth: int = 24
    heads: int = 24
    patch: int = 2
    in_channels: int = 16
    text_dim: int = 4096  # T5 + zero-padded CLIP context
    pooled_dim: int = 2048  # CLIP-L + CLIP-G pooled
    mlp_ratio: int = 4
    pos_embed_max_size: int = 192
    #: diffusers PatchEmbed base grid (sample_size // patch): positions of
    #: the max-size table are scaled to it before the center crop
    base_size: int = 64
    qk_norm: bool = False  # SD3.5 variants: per-head RMSNorm on q and k
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads


def sd3_medium() -> SD3Config:
    return SD3Config()


def sd3_tiny() -> SD3Config:
    """Scaled-down config for tests."""
    return SD3Config(dim=64, depth=2, heads=4, in_channels=4, text_dim=32, pooled_dim=16,
                     pos_embed_max_size=16, base_size=4, qk_norm=True)


def init_sd3(generator: torch.Generator, cfg: SD3Config):
    """Random init on the generator's device: the tree of the JAX
    ``init_sd3``, the blocks stacked on a leading layer axis."""
    d, dt, hd, L = cfg.dim, cfg.dtype, cfg.head_dim, (cfg.depth,)
    dev = generator.device
    blocks = {
        "img_mod": cm.init_linear(generator, d, 6 * d, dtype=dt, stack=L),
        "txt_mod": cm.init_linear(generator, d, 6 * d, dtype=dt, stack=L),
        "img_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "txt_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "img_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "txt_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "img_ffn": cm.init_ffn(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
        "txt_ffn": cm.init_ffn(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
    }
    if cfg.qk_norm:
        for k in ("img_q_norm", "img_k_norm", "txt_q_norm", "txt_k_norm"):
            blocks[k] = cm.init_rmsnorm(hd, dt, dev, L)
    pp = cfg.patch * cfg.patch * cfg.in_channels
    return {
        "patch_embed": cm.init_linear(generator, pp, d, dtype=dt),
        "context_embedder": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "pooled_embed": cm.init_timestep_embedder(generator, cfg.pooled_dim, d, dtype=dt),
        "blocks": blocks,
        "norm_out_mod": cm.init_linear(generator, d, 2 * d, dtype=dt),
        "proj_out": cm.init_linear(generator, d, pp, dtype=dt),
    }


def _heads(x, h):
    b, s, dim = x.shape
    return x.reshape(b, s, h, dim // h)


def _unheads(x):
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def _mod(p, temb, n):
    """n (B, 1, d) modulation vectors from one linear of silu(temb)."""
    return cm.linear(p, cm.silu(temb))[:, None, :].chunk(n, dim=-1)


def _modulate(x, shift, scale):
    return cm.layernorm({}, x) * (1 + scale) + shift


def sd3_embed(params, img, pos_embed, cfg: SD3Config):
    """Patch-embed + positional table -> image hidden tokens (B, S, dim)."""
    return cm.linear(params["patch_embed"], img) + pos_embed.to(cfg.dtype)[None]


def sd3_time_embed(params, pooled, t, cfg: SD3Config):
    """Timestep + pooled-CLIP conditioning (B, d)."""
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    return temb + cm.mlp_embedder(params["pooled_embed"], pooled.to(cfg.dtype))


def sd3_head(params, img, temb, cfg: SD3Config):
    """AdaLN-Continuous norm_out + proj_out -> velocity tokens."""
    scale, shift = _mod(params["norm_out_mod"], temb, 2)
    return cm.linear(params["proj_out"], _modulate(img, shift, scale))


def sd3_joint_scan(blocks, img, txt, temb, cfg: SD3Config, *, attn=SingleDeviceAttn(), attn_state=(),
                   tp_axis=None, mesh=None):
    """The joint blocks (stacked) in order: -> (img, txt, attn_state).

    ``attn`` is one strategy or a tuple of ``(strategy, n_layers)``
    segments (a per-layer compression plan) with ``attn_state`` the tuple of
    their states; states update in place.  ``tp_axis``: the ffns sum over
    that axis of ``mesh``."""
    h = cfg.heads
    depth = cm.weight_shape(blocks["img_mod"])[0]
    for l, (layer_attn, seg_state, seg_l) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
        p = cm.layer_of(blocks, l)
        i_sh_a, i_sc_a, i_g_a, i_sh_m, i_sc_m, i_g_m = _mod(p["img_mod"], temb, 6)
        t_sh_a, t_sc_a, t_g_a, t_sh_m, t_sc_m, t_g_m = _mod(p["txt_mod"], temb, 6)

        iq, ik, iv = (_heads(x, h) for x in cm.linear(p["img_qkv"], _modulate(img, i_sh_a, i_sc_a)).chunk(3, -1))
        tq, tk, tv = (_heads(x, h) for x in cm.linear(p["txt_qkv"], _modulate(txt, t_sh_a, t_sc_a)).chunk(3, -1))
        if cfg.qk_norm:
            iq, ik = cm.rmsnorm(p["img_q_norm"], iq), cm.rmsnorm(p["img_k_norm"], ik)
            tq, tk = cm.rmsnorm(p["txt_q_norm"], tq), cm.rmsnorm(p["txt_k_norm"], tk)

        o, _ = layer_attn(iq, ik, iv, cm.layer_of(seg_state, seg_l), joint_q=tq, joint_k=tk, joint_v=tv)
        s_txt = txt.shape[1]
        txt_o, img_o = o[:, :s_txt], o[:, s_txt:]

        img = img + i_g_a * cm.linear(p["img_out"], _unheads(img_o))
        txt = txt + t_g_a * cm.linear(p["txt_out"], _unheads(txt_o))
        img = img + i_g_m * cm.ffn(p["img_ffn"], _modulate(img, i_sh_m, i_sc_m), tp_axis=tp_axis, mesh=mesh)
        txt = txt + t_g_m * cm.ffn(p["txt_ffn"], _modulate(txt, t_sh_m, t_sc_m), tp_axis=tp_axis, mesh=mesh)
    return img, txt, attn_state


def sd3_forward(
    params,
    img: torch.Tensor,
    txt: torch.Tensor,
    pooled: torch.Tensor,
    t: torch.Tensor,
    cfg: SD3Config,
    *,
    pos_embed: torch.Tensor,
    attn=SingleDeviceAttn(),
    attn_state=(),
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    mesh=None,
):
    """SD3 denoiser on this rank's image tokens.

    img (B, S_img_local, p*p*C); txt (B, S_txt, text_dim); pooled (B,
    pooled_dim); t (B,) timesteps in train units; pos_embed (S_img_local,
    dim) the table of the local tokens.  Returns (velocity, attn_state).

    ``pp_stages`` > 1: sync PipeFusion over the pp axis of ``mesh`` (the
    stack is this stage's layers).  ``tp_axis``: the ffns sum over that
    axis of ``mesh``."""
    if (pp_stages > 1 or tp_axis is not None) and mesh is None:
        raise ValueError(f"PipeFusion ({pp_stages} stages) or TP ({tp_axis}) needs this rank's mesh")
    img = sd3_embed(params, img, pos_embed, cfg)
    txt = cm.linear(params["context_embedder"], txt)
    temb = sd3_time_embed(params, pooled, t, cfg)
    kw = dict(attn=attn, attn_state=attn_state, tp_axis=tp_axis, mesh=mesh)
    if pp_stages > 1:
        if isinstance(attn, (tuple, list)):
            raise ValueError("per-layer compression plans do not compose with pp")
        img, txt = pipefusion_blocks(lambda hh: sd3_joint_scan(params["blocks"], *hh, temb, cfg, **kw)[:2],
                                     (img, txt), mesh)
        return sd3_head(params, img, temb, cfg), attn_state
    img, txt, attn_state = sd3_joint_scan(params["blocks"], img, txt, temb, cfg, **kw)
    return sd3_head(params, img, temb, cfg), attn_state
