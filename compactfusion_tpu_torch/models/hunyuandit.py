"""HunyuanDiT (counterpart of ``compactfusion_tpu/models/hunyuandit.py``).

A cross-attention DiT with long skips (U-ViT): the first half of the
blocks ("down") keeps each block's output, the second half ("up") mixes
the mirror down block's output into its input through a LayerNorm and a
projection.  A block is AdaLN-shift self-attention with 2D rope (the column
coordinate first) and affine per-head LayerNorms on q and k,
cross-attention to the CLIP + T5 text states (queries rotary-embedded),
then a GELU ffn.  Block parameters are stacked on a leading layer axis per
half and the forward is a Python loop over each.

The checkpoint has skip weights for the up blocks past the first only
(``layer > depth // 2``): up slot 0 is a plain block whose converted skip
weights are zeros and never read, and the last down block's output is
never consumed.

Under sync PipeFusion each half's stack is this stage's layers
(``parallel/tp.py``): the down half runs as one pipeline, then each stage
sends its skip stack to its mirror stage and receives the mirror's
(``parallel/pipefusion.py::mirror_exchange``, a point-to-point send and
receive where the JAX package issues one ``ppermute``), and the up half
runs as the next pipeline, up chunk s consuming down chunk P-1-s's skips
in reverse layer order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.models.pixart import _cross_attn
from compactfusion_tpu_torch.parallel.mesh import AXIS_PP
from compactfusion_tpu_torch.parallel.pipefusion import mirror_exchange, pipefusion_blocks


@dataclasses.dataclass(frozen=True)
class HunyuanDiTConfig:
    dim: int = 1408
    depth: int = 40  # even: depth/2 down + depth/2 up (with skips)
    heads: int = 16
    patch: int = 2
    in_channels: int = 4
    out_channels: int = 8
    text_dim: int = 1024  # CLIP (Chinese BERT) states / projected T5 width
    #: raw mT5 state width (projected to text_dim by text_embedder)
    t5_dim: int = 2048
    #: CLIP / T5 token counts (the 77 + 256 = 333 joint context)
    text_len: int = 77
    text_len_t5: int = 256
    #: ffn hidden width: the checkpoint's mlp_ratio 4.3637 gives 6144
    ffn_hidden: int = 6144
    rope_axes: Tuple[int, ...] = (44, 44)  # head_dim 88 over (w, h)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads


def hunyuandit_v12() -> HunyuanDiTConfig:
    return HunyuanDiTConfig()


def hunyuandit_tiny() -> HunyuanDiTConfig:
    """Scaled-down config for tests."""
    return HunyuanDiTConfig(dim=64, depth=4, heads=4, text_dim=32, t5_dim=48, text_len=6, text_len_t5=8,
                            ffn_hidden=128, rope_axes=(8, 8))


def hunyuandit_positions(hp: int, wp: int, device=None) -> torch.Tensor:
    """(hp*wp, 2) rope ids in raster order, the COLUMN coordinate first
    (diffusers ``get_2d_rotary_pos_embed`` builds its grid with
    ``meshgrid(w, h)``)."""
    return cm.patch_positions_2d(hp, wp, device).flip(1)


def _init_blocks(generator, cfg: HunyuanDiTConfig, with_skip: bool):
    d, dt, hd, L = cfg.dim, cfg.dtype, cfg.head_dim, (cfg.depth // 2,)
    dev = generator.device
    p = {
        # AdaLayerNormShift: an affine LayerNorm + a shift from linear(silu(temb))
        "mod_shift": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "norm1": cm.init_layernorm(d, dt, dev, L),
        "attn_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "q_norm": cm.init_layernorm(hd, dt, dev, L),
        "k_norm": cm.init_layernorm(hd, dt, dev, L),
        "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "norm2": cm.init_layernorm(d, dt, dev, L),
        "cross_q": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "cross_kv": cm.init_linear(generator, cfg.text_dim, 2 * d, dtype=dt, stack=L),
        "cross_q_norm": cm.init_layernorm(hd, dt, dev, L),
        "cross_k_norm": cm.init_layernorm(hd, dt, dev, L),
        "cross_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "norm3": cm.init_layernorm(d, dt, dev, L),
        "ffn": cm.init_ffn(generator, d, cfg.ffn_hidden, dtype=dt, stack=L),
    }
    if with_skip:
        p["skip_norm"] = cm.init_layernorm(2 * d, dt, dev, L)
        p["skip_proj"] = cm.init_linear(generator, 2 * d, d, dtype=dt, stack=L)
    return p


def init_hunyuandit(generator: torch.Generator, cfg: HunyuanDiTConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_hunyuandit``, each half's blocks stacked on a leading layer axis."""
    if cfg.depth % 2:
        raise ValueError(f"HunyuanDiT depth {cfg.depth} is not even")
    d, dt, dev = cfg.dim, cfg.dtype, generator.device
    t5 = cfg.t5_dim
    return {
        "patch_embed": cm.init_linear(generator, cfg.patch ** 2 * cfg.in_channels, d, dtype=dt),
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        # v1.2's conditioning: T5 projection, learned padding rows, the
        # attention pool of the T5 states (no style or size embedding)
        "text_embedder": {"fc1": cm.init_linear(generator, t5, 4 * t5, dtype=dt),
                          "fc2": cm.init_linear(generator, 4 * t5, cfg.text_dim, dtype=dt)},
        "text_pad": torch.zeros((cfg.text_len + cfg.text_len_t5, cfg.text_dim), dtype=dt, device=dev),
        "pooler": {
            "pos": torch.zeros((cfg.text_len_t5 + 1, t5), dtype=dt, device=dev),
            "q": cm.init_linear(generator, t5, t5, dtype=dt),
            "k": cm.init_linear(generator, t5, t5, dtype=dt),
            "v": cm.init_linear(generator, t5, t5, dtype=dt),
            "out": cm.init_linear(generator, t5, cfg.text_dim, dtype=dt),
        },
        "extra_embedder": {"fc1": cm.init_linear(generator, cfg.text_dim, 4 * d, dtype=dt),
                           "fc2": cm.init_linear(generator, 4 * d, d, dtype=dt)},
        "down_blocks": _init_blocks(generator, cfg, False),
        "up_blocks": _init_blocks(generator, cfg, True),
        "norm_out_mod": cm.init_linear(generator, d, 2 * d, dtype=dt),
        "proj_out": cm.init_linear(generator, d, cfg.patch ** 2 * cfg.out_channels, dtype=dt),
    }


def _attention_pool(p, x: torch.Tensor) -> torch.Tensor:
    """HunyuanDiTAttentionPool: the mean token in front, a learned
    positional table added, one 8-head attention with the mean token as the
    only query (fp32 scores and softmax), projected out -> (B, text_dim)."""
    b, s, c = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + p["pos"].to(x.dtype)[None]
    heads = 8
    hd = c // heads
    q = cm.linear(p["q"], x[:, :1]).reshape(b, 1, heads, hd)
    k = cm.linear(p["k"], x).reshape(b, s + 1, heads, hd)
    v = cm.linear(p["v"], x).reshape(b, s + 1, heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, k.float())
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v.float())
    return cm.linear(p["out"], o.reshape(b, 1, c).to(x.dtype))[:, 0]


def hunyuandit_condition(params, clip_text: torch.Tensor, t5_text: torch.Tensor,
                         clip_mask: Optional[torch.Tensor], t5_mask: Optional[torch.Tensor],
                         cfg: HunyuanDiTConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint text context and the extra timestep conditioning from raw
    CLIP and T5 states (diffusers ``HunyuanDiT2DModel.forward``): the T5
    states projected through ``text_embedder`` follow the CLIP states,
    masked rows take the LEARNED ``text_pad`` rows (no attention mask
    afterwards); the extra embedding is the attention-pooled T5 states
    through ``extra_embedder``.  Returns (text (B, 77 + 256, text_dim),
    temb_extra (B, dim))."""
    te = params["text_embedder"]
    t5_proj = cm.linear(te["fc2"], cm.silu(cm.linear(te["fc1"], t5_text)))
    text = torch.cat([clip_text.to(t5_proj.dtype), t5_proj], dim=1)
    if clip_mask is None:
        clip_mask = torch.ones(clip_text.shape[:2], dtype=torch.bool, device=text.device)
    if t5_mask is None:
        t5_mask = torch.ones(t5_text.shape[:2], dtype=torch.bool, device=text.device)
    mask = torch.cat([clip_mask, t5_mask], dim=1)
    text = torch.where(mask[..., None], text, params["text_pad"].to(text.dtype)[None])
    pooled = _attention_pool(params["pooler"], t5_text.to(text.dtype))
    ex = params["extra_embedder"]
    return text, cm.linear(ex["fc2"], cm.silu(cm.linear(ex["fc1"], pooled)))


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _unheads(x):
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def _block(p, x, state, attn, temb, text, cfg, rope, kv_lens, tp_axis, mesh):
    """One block: AdaLN-shift self-attention with rope and affine qk norms,
    cross-attention to the text (queries rotary-embedded too, as diffusers'
    ``HunyuanAttnProcessor2_0``), then the ffn."""
    h = cfg.heads
    cos, sin = rope
    shift = cm.linear(p["mod_shift"], cm.silu(temb))[:, None, :]
    xn = cm.layernorm(p["norm1"], x) + shift
    q, k, v = (_heads(y, h) for y in cm.linear(p["attn_qkv"], xn).chunk(3, dim=-1))
    q, k = cm.layernorm(p["q_norm"], q), cm.layernorm(p["k_norm"], k)
    q, k = cm.apply_rope(q, cos, sin), cm.apply_rope(k, cos, sin)
    o, _ = attn(q, k, v, state)
    x = x + cm.linear(p["attn_out"], _unheads(o))

    xn = cm.layernorm(p["norm2"], x)
    q = _heads(cm.linear(p["cross_q"], xn), h)
    kt, vt = cm.linear(p["cross_kv"], text).chunk(2, dim=-1)
    q = cm.apply_rope(cm.layernorm(p["cross_q_norm"], q), cos, sin)
    kt = cm.layernorm(p["cross_k_norm"], _heads(kt, h))
    o = _cross_attn(q, kt, _heads(vt, h), None, kv_lens=kv_lens)
    x = x + cm.linear(p["cross_out"], _unheads(o))

    return x + cm.ffn(p["ffn"], cm.layernorm(p["norm3"], x), tp_axis=tp_axis, mesh=mesh)


def hunyuandit_down_scan(blocks, x, temb, text, cfg, *, rope, attn=SingleDeviceAttn(), attn_state=(),
                         kv_lens=None, tp_axis=None, mesh=None):
    """The (stacked) down blocks: -> (x, attn_state, skip stack (L, B, S,
    dim), each block's output).  ``attn`` is one strategy or a tuple of
    ``(strategy, n_layers)`` segments with ``attn_state`` their states."""
    depth = cm.weight_shape(blocks["attn_qkv"])[0]
    skips = []
    for l, (a, st, sl) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
        x = _block(cm.layer_of(blocks, l), x, cm.layer_of(st, sl), a, temb, text, cfg, rope, kv_lens, tp_axis,
                   mesh)
        skips.append(x)
    return x, attn_state, torch.stack(skips)


def hunyuandit_up_scan(blocks, x, skips, temb, text, cfg, *, rope, attn=SingleDeviceAttn(), attn_state=(),
                       kv_lens=None, tp_axis=None, mesh=None, offset: int = 0):
    """The (stacked) up blocks consuming ``skips`` (already in consumption
    order): -> (x, attn_state).  ``offset`` is the global up-slot index of
    local slot 0 (the stage's offset under PipeFusion): global slot 0 takes
    no skip."""
    depth = cm.weight_shape(blocks["attn_qkv"])[0]
    for l, (a, st, sl) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
        p = cm.layer_of(blocks, l)
        if offset + l > 0:
            cat = torch.cat([x, skips[l]], dim=-1)
            x = cm.linear(p["skip_proj"], cm.layernorm(p["skip_norm"], cat))
        x = _block(p, x, cm.layer_of(st, sl), a, temb, text, cfg, rope, kv_lens, tp_axis, mesh)
    return x, attn_state


def hunyuandit_head(params, x, temb, cfg: HunyuanDiTConfig):
    scale, shift = cm.linear(params["norm_out_mod"], cm.silu(temb))[:, None, :].chunk(2, dim=-1)
    return cm.linear(params["proj_out"], cm.layernorm({}, x) * (1 + scale) + shift)


def hunyuandit_forward(
    params,
    x: torch.Tensor,
    t: torch.Tensor,
    text: torch.Tensor,
    cfg: HunyuanDiTConfig,
    *,
    rope: Tuple[torch.Tensor, torch.Tensor],
    attn=SingleDeviceAttn(),
    attn_state_down=(),
    attn_state_up=(),
    attn_up=None,
    text_mask: Optional[torch.Tensor] = None,
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    temb_extra: Optional[torch.Tensor] = None,
    mesh=None,
):
    """HunyuanDiT denoiser on this rank's tokens.

    x (B, S_local, p*p*C); t (B,); text (B, S_txt, text_dim) (built by
    :func:`hunyuandit_condition` with ``temb_extra``, and then
    ``text_mask=None``: the masked rows carry the learned padding); rope
    (cos, sin) of the local tokens.  ``attn_up``: the up half's strategy
    when it differs (per-layer plans give each half a tuple of segments and
    a tuple of states).  Returns (out, state_down, state_up).

    ``pp_stages`` > 1: sync PipeFusion with the mirror skip channel over
    the pp axis of ``mesh``.  ``tp_axis``: the ffns sum over that axis of
    ``mesh``."""
    if (pp_stages > 1 or tp_axis is not None) and mesh is None:
        raise ValueError(f"PipeFusion ({pp_stages} stages) or TP ({tp_axis}) needs this rank's mesh")
    x = cm.linear(params["patch_embed"], x)
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    if temb_extra is not None:
        temb = temb + temb_extra.to(temb.dtype)
    # padding masks are contiguous prefixes: a per-batch length
    kv_lens = None if text_mask is None else text_mask.sum(dim=-1).to(torch.int32)
    kw = dict(rope=rope, kv_lens=kv_lens, tp_axis=tp_axis, mesh=mesh)
    a_up = attn if attn_up is None else attn_up
    if pp_stages > 1:
        if isinstance(attn, (tuple, list)) or a_up is not attn:
            raise ValueError("per-layer compression plans do not compose with pp")
        got = {}

        def down_stage(h):
            h, _, got["skips"] = hunyuandit_down_scan(params["down_blocks"], h, temb, text, cfg, attn=attn,
                                                      attn_state=attn_state_down, **kw)
            return h

        x = pipefusion_blocks(down_stage, x, mesh)
        # up chunk s consumes down chunk P-1-s's skips, in reverse layer order
        skips = mirror_exchange(got["skips"], mesh).flip(0)
        l_loc = skips.shape[0]
        offset = mesh.axis_index(AXIS_PP) * l_loc
        x = pipefusion_blocks(lambda h: hunyuandit_up_scan(params["up_blocks"], h, skips, temb, text, cfg,
                                                           attn=attn, attn_state=attn_state_up, offset=offset,
                                                           **kw)[0], x, mesh)
        return hunyuandit_head(params, x, temb, cfg), attn_state_down, attn_state_up
    x, state_down, skips = hunyuandit_down_scan(params["down_blocks"], x, temb, text, cfg, attn=attn,
                                                attn_state=attn_state_down, **kw)
    # mirror order: up block k consumes down block (half-1-k)'s output
    x, state_up = hunyuandit_up_scan(params["up_blocks"], x, skips.flip(0), temb, text, cfg, attn=a_up,
                                     attn_state=attn_state_up, **kw)
    return hunyuandit_head(params, x, temb, cfg), state_down, state_up
