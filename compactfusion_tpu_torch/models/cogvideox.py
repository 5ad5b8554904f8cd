"""CogVideoX 3D video DiT (counterpart of ``compactfusion_tpu/models/cogvideox.py``).

Joint text + video blocks in which one set of attention and FF weights
serves both streams and only the AdaLN modulations differ
(CogVideoXLayerNormZero), per-head affine LayerNorm on q and k, the text at
the front of the joint sequence, a v-prediction head.  Positions: a 2D
sin-cos table over (frames x rows, cols) for 2B, 3D (t, h, w) rotary
embedding in the rotate-half layout for 5B and 1.5-5B (which also groups
latent frames in pairs per token and adds the ``ofs`` embedding).  Block
parameters are stacked on a leading layer axis, as ``init_cogvideox`` of
the JAX package builds them, and the forward is a Python loop over it.

Under sequence parallelism the video tokens are this rank's shard and the
text rides as the attention's joint front tensors, as in FLUX.  Under sync
PipeFusion the stack is this stage's blocks (``parallel/tp.py``); under
tensor parallelism the ffn of the joined stream sums over the tp axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.parallel.mesh import AXIS_PP
from compactfusion_tpu_torch.parallel.pipefusion import pipefusion_blocks


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    dim: int = 1920
    depth: int = 30
    heads: int = 30
    patch: int = 2
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    time_embed_dim: int = 512
    ffn_mult: int = 4
    use_rotary: bool = True  # 1.5/5B; 2B adds a sin-cos table
    #: temporal patch (CogVideoX 1.5: 2 latent frames a token; the pipeline
    #: pads the latent frames to a multiple and drops the padding)
    patch_t: int = 1
    #: rope head-dim split over (t, h, w)
    axes_dim: Tuple[int, ...] = (16, 24, 24)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads

    @property
    def token_in(self) -> int:
        """Channels a patchified token holds: (p_t, p, p, C) packed."""
        return self.patch_t * self.patch * self.patch * self.in_channels

    @property
    def token_out(self) -> int:
        return self.patch_t * self.patch * self.patch * self.out_channels


def cogvideox_2b() -> CogVideoXConfig:
    return CogVideoXConfig(dim=1920, depth=30, heads=30, use_rotary=False)


def cogvideox_5b() -> CogVideoXConfig:
    return CogVideoXConfig(dim=3072, depth=42, heads=48, axes_dim=(16, 24, 24))


def cogvideox_1_5_5b() -> CogVideoXConfig:
    """CogVideoX1.5-5B (T2V): the 5B geometry with ``patch_t=2``."""
    return CogVideoXConfig(dim=3072, depth=42, heads=48, patch_t=2)


def cogvideox_tiny(patch_t: int = 1) -> CogVideoXConfig:
    return CogVideoXConfig(dim=64, depth=2, heads=4, text_dim=32, time_embed_dim=32, axes_dim=(8, 4, 4),
                           patch_t=patch_t)


def init_cogvideox(generator: torch.Generator, cfg: CogVideoXConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_cogvideox`` (other draws), the blocks stacked on a leading
    layer axis."""
    d, dt, hd, L = cfg.dim, cfg.dtype, cfg.head_dim, (cfg.depth,)
    dev = generator.device
    blocks = {
        # CogVideoXLayerNormZero: temb -> (shift, scale, gate) for the video
        # stream and for the text stream; the norm is an affine LayerNorm
        "mod_attn": cm.init_linear(generator, cfg.time_embed_dim, 6 * d, dtype=dt, stack=L),
        "norm1": cm.init_layernorm(d, dt, dev, L),
        "mod_ff": cm.init_linear(generator, cfg.time_embed_dim, 6 * d, dtype=dt, stack=L),
        "norm2": cm.init_layernorm(d, dt, dev, L),
        "qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        # qk norm: a per-head affine LayerNorm (eps 1e-6)
        "q_norm": cm.init_layernorm(hd, dt, dev, L),
        "k_norm": cm.init_layernorm(hd, dt, dev, L),
        "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "ffn": cm.init_ffn(generator, d, cfg.ffn_mult * d, dtype=dt, stack=L),
    }
    p = {
        "patch_embed": cm.init_linear(generator, cfg.token_in, d, dtype=dt),
        "text_proj": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        # the timestep sinusoid is dim-wide (diffusers Timesteps(inner_dim))
        "t_embed": cm.init_timestep_embedder(generator, d, cfg.time_embed_dim, dtype=dt),
        "blocks": blocks,
        "norm_final": cm.init_layernorm(d, dt, dev),
        "norm_out_mod": cm.init_linear(generator, cfg.time_embed_dim, 2 * d, dtype=dt),
        "norm_out_norm": cm.init_layernorm(d, dt, dev),
        "proj_out": cm.init_linear(generator, d, cfg.token_out, dtype=dt),
    }
    if cfg.patch_t > 1:
        p["ofs_embed"] = cm.init_timestep_embedder(generator, cfg.time_embed_dim, cfg.time_embed_dim, dtype=dt)
    return p


def video_positions(frames: int, hp: int, wp: int, device=None) -> torch.Tensor:
    """(frames*hp*wp, 3) int64 (t, row, col) ids, frame-major raster order."""
    t = torch.arange(frames, device=device).repeat_interleave(hp * wp)
    rc = cm.patch_positions_2d(hp, wp, device).repeat(frames, 1)
    return torch.cat([t[:, None], rc], dim=-1)


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _unheads(x):
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def _mod6(p, temb):
    """(shift, scale, gate) of the video stream, then of the text stream,
    each (B, 1, d)."""
    return cm.linear(p, cm.silu(temb))[:, None, :].chunk(6, dim=-1)


def cogvideox_forward(
    params,
    video: torch.Tensor,
    txt: torch.Tensor,
    t: torch.Tensor,
    cfg: CogVideoXConfig,
    *,
    video_rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pos_embed: Optional[torch.Tensor] = None,
    attn=SingleDeviceAttn(),
    attn_state=(),
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    mesh=None,
    after_block=None,
):
    """CogVideoX denoiser on this rank's video tokens.

    video (B, S_local, token_in) patchified latent tokens; txt (B, S_txt,
    text_dim); t (B,) train-unit timesteps; video_rope (cos, sin) of the
    local tokens (rotary models); pos_embed (S_local, dim) the sin-cos table
    (2B).  ``attn`` is one strategy or a tuple of ``(strategy, n_layers)``
    segments with ``attn_state`` the tuple of their states, updated in
    place.  Returns (v prediction (B, S_local, token_out), attn_state).
    ``pp_stages`` > 1: sync PipeFusion over the pp axis of ``mesh``, the
    blocks this stage's layers; ``tp_axis``: the ffn of the joined text +
    video stream sums over that axis of ``mesh``.  ``after_block(layer,
    vid) -> vid`` runs after every block with the block's index in the whole
    stack (ConsisID's identity injection, ``models/consisid.py``)."""
    if (pp_stages > 1 or tp_axis is not None) and mesh is None:
        raise ValueError(f"PipeFusion ({pp_stages} stages) or TP ({tp_axis}) needs this rank's mesh")
    if pp_stages > 1 and isinstance(attn, (tuple, list)):
        raise ValueError("per-layer compression plans do not compose with pp")
    h = cfg.heads
    vid = cm.linear(params["patch_embed"], video)
    if pos_embed is not None:
        vid = vid + pos_embed.to(cfg.dtype)[None]
    txt = cm.linear(params["text_proj"], txt)
    temb = cm.timestep_embedder(params["t_embed"], t, cfg.dim)
    if "ofs_embed" in params:
        # CogVideoX 1.5: the ofs branch, fed the constant 2.0 in text-to-video
        ofs = torch.full(t.shape, 2.0, dtype=torch.float32, device=t.device)
        temb = temb + cm.timestep_embedder(params["ofs_embed"], ofs, cfg.time_embed_dim)
    if video_rope is not None:
        # the params are in the rotate-half rope layout (io/hf.py permutes
        # the checkpoint's interleaved Wq/Wk columns and qk-norm affines)
        cos_v, sin_v = cm.rope_half_tables(*video_rope)

    blocks = params["blocks"]
    s_txt = txt.shape[1]
    depth = cm.weight_shape(blocks["qkv"])[0]

    def block(p, layer_attn, state, vid, txt):
        v_sh, v_sc, v_g, t_sh, t_sc, t_g = _mod6(p["mod_attn"], temb)
        vid_n = cm.layernorm(p["norm1"], vid, eps=1e-5) * (1 + v_sc) + v_sh
        txt_n = cm.layernorm(p["norm1"], txt, eps=1e-5) * (1 + t_sc) + t_sh
        # one projection serves both streams
        vq, vk, vv = (_heads(x, h) for x in cm.linear(p["qkv"], vid_n).chunk(3, dim=-1))
        tq, tk, tv = (_heads(x, h) for x in cm.linear(p["qkv"], txt_n).chunk(3, dim=-1))
        vq, vk = cm.layernorm(p["q_norm"], vq, eps=1e-6), cm.layernorm(p["k_norm"], vk, eps=1e-6)
        tq, tk = cm.layernorm(p["q_norm"], tq, eps=1e-6), cm.layernorm(p["k_norm"], tk, eps=1e-6)
        if video_rope is not None:
            vq, vk = cm.apply_rope_half(vq, cos_v, sin_v), cm.apply_rope_half(vk, cos_v, sin_v)

        o, _ = layer_attn(vq, vk, vv, state, joint_q=tq, joint_k=tk, joint_v=tv)
        proj = cm.linear(p["attn_out"], _unheads(o))  # text rows first
        txt = txt + t_g * proj[:, :s_txt]
        vid = vid + v_g * proj[:, s_txt:]

        v_sh, v_sc, v_g, t_sh, t_sc, t_g = _mod6(p["mod_ff"], temb)
        vid_n = cm.layernorm(p["norm2"], vid, eps=1e-5) * (1 + v_sc) + v_sh
        txt_n = cm.layernorm(p["norm2"], txt, eps=1e-5) * (1 + t_sc) + t_sh
        ff = cm.ffn(p["ffn"], torch.cat([txt_n, vid_n], dim=1), tp_axis=tp_axis, mesh=mesh)
        txt = txt + t_g * ff[:, :s_txt]
        vid = vid + v_g * ff[:, s_txt:]
        return vid, txt

    # this stage's first layer in the whole stack
    first = mesh.axis_index(AXIS_PP) * depth if pp_stages > 1 else 0

    def run_local(hh):
        vid, txt = hh
        for l, (layer_attn, seg_state, seg_l) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
            vid, txt = block(cm.layer_of(blocks, l), layer_attn, cm.layer_of(seg_state, seg_l), vid, txt)
            if after_block is not None:
                vid = after_block(first + l, vid)
        return vid, txt

    if pp_stages > 1:
        vid, txt = pipefusion_blocks(run_local, (vid, txt), mesh)
    else:
        vid, txt = run_local((vid, txt))

    # norm_final over the joint sequence (the video rows kept), then
    # AdaLayerNorm: shift first, affine inner norm
    vid = cm.layernorm(params["norm_final"], torch.cat([txt, vid], dim=1), eps=1e-5)[:, s_txt:]
    shift, scale = cm.linear(params["norm_out_mod"], cm.silu(temb))[:, None, :].chunk(2, dim=-1)
    vid = cm.layernorm(params["norm_out_norm"], vid, eps=1e-5) * (1 + scale) + shift
    return cm.linear(params["proj_out"], vid), attn_state
