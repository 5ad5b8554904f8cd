"""FLUX.1 transformer (counterpart of ``compactfusion_tpu/models/flux.py``).

19 double (MMDiT) blocks with separate image and text streams joined for
attention, 38 single blocks on the fused stream, multi-axis RoPE in the
rotate-half layout, AdaLN-Zero modulation from timestep + pooled-CLIP (+
guidance) embeddings, a flow-matching velocity head.  Block parameters are
stacked on a leading layer axis per family, as in ``init_flux`` of the JAX
package, and each family's forward is a Python loop over that axis.

Under sequence parallelism the image tokens are this rank's shard and the
text tokens ride as joint front tensors of the attention strategy, so only
image K/V crosses ranks (and is compressed).  Under sync PipeFusion each
family's stack is this stage's layers (``parallel/tp.py``, after
:func:`pad_flux_for_pp`) and the two families run as two pipelines; under
tensor parallelism both streams' ffns and the single blocks' MLP half sum
over the tp axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from compactfusion_tpu_torch.cache.accel import PIPEFUSION_REFUSAL, CacheAccelState, next_probe, should_skip
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.parallel.pipefusion import pipefusion_blocks
from compactfusion_tpu_torch.utils.prof import span


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    dim: int = 3072
    double_layers: int = 19
    single_layers: int = 38
    heads: int = 24
    in_channels: int = 64  # 2x2-packed 16-channel latent
    text_dim: int = 4096  # T5-XXL
    pooled_dim: int = 768  # CLIP-L pooled
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    mlp_ratio: int = 4
    guidance_embeds: bool = True  # FLUX.1-dev (schnell: False)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads


def flux_dev() -> FluxConfig:
    return FluxConfig()


def flux_schnell() -> FluxConfig:
    return FluxConfig(guidance_embeds=False)


def flux_tiny() -> FluxConfig:
    """Scaled-down config for tests (head_dim 16 -> axes (4, 6, 6))."""
    return FluxConfig(dim=64, double_layers=2, single_layers=2, heads=4, in_channels=16,
                      text_dim=32, pooled_dim=16, axes_dim=(4, 6, 6))


# ---------------------------------------------------------------------------
# init (torch.Generator draws on its device; other draws than the JAX init)
# ---------------------------------------------------------------------------


def _init_double_blocks(generator, cfg: FluxConfig):
    d, dt, hd, L = cfg.dim, cfg.dtype, cfg.head_dim, (cfg.double_layers,)
    dev = generator.device
    return {
        "img_mod": cm.init_linear(generator, d, 6 * d, dtype=dt, stack=L),
        "txt_mod": cm.init_linear(generator, d, 6 * d, dtype=dt, stack=L),
        "img_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "txt_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "img_q_norm": cm.init_rmsnorm(hd, dt, dev, L),
        "img_k_norm": cm.init_rmsnorm(hd, dt, dev, L),
        "txt_q_norm": cm.init_rmsnorm(hd, dt, dev, L),
        "txt_k_norm": cm.init_rmsnorm(hd, dt, dev, L),
        "img_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "txt_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "img_ffn": cm.init_ffn(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
        "txt_ffn": cm.init_ffn(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
    }


def _init_single_blocks(generator, cfg: FluxConfig):
    d, dt, hd, L = cfg.dim, cfg.dtype, cfg.head_dim, (cfg.single_layers,)
    dev = generator.device
    return {
        "mod": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "q_norm": cm.init_rmsnorm(hd, dt, dev, L),
        "k_norm": cm.init_rmsnorm(hd, dt, dev, L),
        # the checkpoint's fused proj_out, stored split as in the JAX package:
        # the MLP half (fc2) and the attention half (out_attn, with the bias)
        "mlp": {
            "fc1": cm.init_linear(generator, d, cfg.mlp_ratio * d, dtype=dt, stack=L),
            "fc2": cm.init_linear(generator, cfg.mlp_ratio * d, d, bias=False, dtype=dt, stack=L),
        },
        "out_attn": cm.init_linear(generator, d, d, dtype=dt, stack=L),
    }


def init_flux(generator: torch.Generator, cfg: FluxConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_flux``, both block families stacked on a leading layer axis."""
    d, dt = cfg.dim, cfg.dtype
    p = {
        "x_embedder": cm.init_linear(generator, cfg.in_channels, d, dtype=dt),
        "context_embedder": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "pooled_embed": cm.init_timestep_embedder(generator, cfg.pooled_dim, d, dtype=dt),
        "double_blocks": _init_double_blocks(generator, cfg),
        "single_blocks": _init_single_blocks(generator, cfg),
        "norm_out_mod": cm.init_linear(generator, d, 2 * d, dtype=dt),
        "proj_out": cm.init_linear(generator, d, cfg.in_channels, dtype=dt),
    }
    if cfg.guidance_embeds:
        p["guidance_embed"] = cm.init_timestep_embedder(generator, 256, d, dtype=dt)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _heads(x, h):
    b, s, dim = x.shape
    return x.reshape(b, s, h, dim // h)


def _unheads(x):
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def _mod(p, temb, n):
    """n (B, 1, d) modulation vectors from one linear of silu(temb)."""
    out = cm.linear(p, cm.silu(temb))
    return out[:, None, :].chunk(n, dim=-1)


def _modulate(x, shift, scale):
    return cm.layernorm({}, x) * (1 + scale) + shift


def flux_image_positions(hp: int, wp: int, device=None) -> torch.Tensor:
    """(hp*wp, 3) FLUX image token ids (0, row, col)."""
    pos = cm.patch_positions_2d(hp, wp, device)
    return torch.cat([torch.zeros_like(pos[:, :1]), pos], dim=-1)


def pad_flux_for_pp(params, cfg: FluxConfig, ps: int):
    """Pad both block stacks with zero blocks so that each count divides
    ``ps`` stages (FLUX.1 has 19 double blocks, a prime).  A block whose
    modulation weights and biases are 0 has shift = scale = gate = 0, so
    its attention and MLP are gated off and the stream passes it unchanged
    (AdaLN-Zero).  Returns (padded params, padded cfg); the given tree when
    both counts divide already."""
    def pad(stack, extra):
        if isinstance(stack, dict):
            return {k: pad(v, extra) for k, v in stack.items()}
        return torch.cat([stack, stack.new_zeros((extra,) + tuple(stack.shape[1:]))])

    d_extra, s_extra = (-cfg.double_layers) % ps, (-cfg.single_layers) % ps
    if d_extra == 0 and s_extra == 0:
        return params, cfg
    params = dict(params)
    if d_extra:
        params["double_blocks"] = pad(params["double_blocks"], d_extra)
    if s_extra:
        params["single_blocks"] = pad(params["single_blocks"], s_extra)
    return params, dataclasses.replace(cfg, double_layers=cfg.double_layers + d_extra,
                                       single_layers=cfg.single_layers + s_extra)


def flux_time_embed(params, pooled, t, guidance, cfg: FluxConfig):
    """Combined timestep + pooled-CLIP (+ guidance) conditioning (B, d)."""
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    temb = temb + cm.mlp_embedder(params["pooled_embed"], pooled.to(cfg.dtype))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("FLUX with guidance_embeds needs a guidance value")
        temb = temb + cm.timestep_embedder(params["guidance_embed"], guidance, 256)
    return temb


def flux_double_scan(blocks, img, txt, temb, cfg: FluxConfig, *, img_rope, txt_rope,
                     attn=SingleDeviceAttn(), attn_state=(), tp_axis=None, mesh=None):
    """The double blocks (stacked) in order: -> (img, txt, attn_state).

    ``attn`` is one strategy or a tuple of ``(strategy, n_layers)`` segments
    (per-layer compression plans) with ``attn_state`` the tuple of their
    states; states update in place and are returned.  ``tp_axis``: the ffns
    sum over that axis of ``mesh``."""
    with span("double_blocks"):
        h = cfg.heads
        # the params live in the rotate-half rope layout (io/hf.py permutes the
        # checkpoint's interleaved Wq/Wk columns)
        cos_i, sin_i = cm.rope_half_tables(*img_rope)
        cos_t, sin_t = cm.rope_half_tables(*txt_rope)
        depth = cm.weight_shape(blocks["img_mod"])[0]
        for l, (layer_attn, seg_state, seg_l) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
            with span("modulate"):
                p = cm.layer_of(blocks, l)
                i_sh_a, i_sc_a, i_g_a, i_sh_m, i_sc_m, i_g_m = _mod(p["img_mod"], temb, 6)
                t_sh_a, t_sc_a, t_g_a, t_sh_m, t_sc_m, t_g_m = _mod(p["txt_mod"], temb, 6)
                img_n = _modulate(img, i_sh_a, i_sc_a)
                txt_n = _modulate(txt, t_sh_a, t_sc_a)
            with span("qkv"):
                iq, ik, iv = (_heads(x, h) for x in cm.linear(p["img_qkv"], img_n).chunk(3, dim=-1))
                tq, tk, tv = (_heads(x, h) for x in cm.linear(p["txt_qkv"], txt_n).chunk(3, dim=-1))
            with span("qk_norm_rope"):
                iq, ik = cm.rmsnorm(p["img_q_norm"], iq), cm.rmsnorm(p["img_k_norm"], ik)
                tq, tk = cm.rmsnorm(p["txt_q_norm"], tq), cm.rmsnorm(p["txt_k_norm"], tk)
                iq, ik = cm.apply_rope_half(iq, cos_i, sin_i), cm.apply_rope_half(ik, cos_i, sin_i)
                tq, tk = cm.apply_rope_half(tq, cos_t, sin_t), cm.apply_rope_half(tk, cos_t, sin_t)
            with span("attention"):
                o, _ = layer_attn(iq, ik, iv, cm.layer_of(seg_state, seg_l), joint_q=tq, joint_k=tk,
                                  joint_v=tv)
                s_txt = txt.shape[1]
                txt_o, img_o = o[:, :s_txt], o[:, s_txt:]
            with span("out_gate"):
                img = img + i_g_a * cm.linear(p["img_out"], _unheads(img_o))
                txt = txt + t_g_a * cm.linear(p["txt_out"], _unheads(txt_o))
            with span("modulate"):
                img_n = _modulate(img, i_sh_m, i_sc_m)
                txt_n = _modulate(txt, t_sh_m, t_sc_m)
            with span("ffn_gate"):
                img = img + i_g_m * cm.ffn(p["img_ffn"], img_n, tp_axis=tp_axis, mesh=mesh)
                txt = txt + t_g_m * cm.ffn(p["txt_ffn"], txt_n, tp_axis=tp_axis, mesh=mesh)
    return img, txt, attn_state


def flux_single_scan(blocks, img, txt, temb, cfg: FluxConfig, *, img_rope, txt_rope,
                     attn=SingleDeviceAttn(), attn_state=(), tp_axis=None, mesh=None):
    """The single blocks (stacked) on the fused (txt | img) stream:
    -> (img, txt, attn_state).

    Two routes, one computation (``test_flux_single_scan_fused_matches_
    generic`` pins it): with a stateless ``SingleDeviceAttn`` (the exact
    type) the stream stays concatenated across the blocks and q/k rotate by
    one fused rope table (rope is positionwise, so concat∘rope ==
    rope∘concat); any other strategy gets the text rows as joint tensors."""
    with span("single_blocks"):
        h = cfg.heads
        cos_i, sin_i = cm.rope_half_tables(*img_rope)
        cos_t, sin_t = cm.rope_half_tables(*txt_rope)
        s_txt = txt.shape[1]
        depth = cm.weight_shape(blocks["mod"])[0]

        def modulate(p, x):
            sh, sc, g = _mod(p["mod"], temb, 3)
            return _modulate(x, sh, sc), g

        def qkv(p, xn):
            return (_heads(y, h) for y in cm.linear(p["qkv"], xn).chunk(3, dim=-1))

        def out_proj(p, o, xn, x, g):
            # [attn_out, gelu(mlp)] @ proj_out, the MLP half as a GELU FFN
            # (split over tp; the attention half stays whole)
            y = cm.linear(p["out_attn"], _unheads(o)) + cm.ffn(p["mlp"], xn, tp_axis=tp_axis, mesh=mesh)
            return x + g * y

        if type(attn) is SingleDeviceAttn and not cm.has_tensors(attn_state):
            cos_f = torch.cat([cos_t, cos_i], dim=0)
            sin_f = torch.cat([sin_t, sin_i], dim=0)
            x = torch.cat([txt, img], dim=1)
            for l in range(depth):
                with span("modulate"):
                    p = cm.layer_of(blocks, l)
                    xn, g = modulate(p, x)
                with span("qkv"):
                    q, k, v = qkv(p, xn)
                with span("qk_norm_rope"):
                    q, k = cm.rmsnorm(p["q_norm"], q), cm.rmsnorm(p["k_norm"], k)
                    q, k = cm.apply_rope_half(q, cos_f, sin_f), cm.apply_rope_half(k, cos_f, sin_f)
                with span("attention"):
                    o, _ = attn(q, k, v, ())
                with span("ffn_gate"):
                    x = out_proj(p, o, xn, x, g)
            return x[:, s_txt:], x[:, :s_txt], attn_state

        for l, (layer_attn, seg_state, seg_l) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
            with span("modulate"):
                p = cm.layer_of(blocks, l)
                x = torch.cat([txt, img], dim=1)
                xn, g = modulate(p, x)
            with span("qkv"):
                q, k, v = qkv(p, xn)
            with span("qk_norm_rope"):
                q, k = cm.rmsnorm(p["q_norm"], q), cm.rmsnorm(p["k_norm"], k)
                # the joint (text) rows are the first s_txt tokens of the stream
                tq, iq = q[:, :s_txt], q[:, s_txt:]
                tk, ik = k[:, :s_txt], k[:, s_txt:]
                iq, ik = cm.apply_rope_half(iq, cos_i, sin_i), cm.apply_rope_half(ik, cos_i, sin_i)
                tq, tk = cm.apply_rope_half(tq, cos_t, sin_t), cm.apply_rope_half(tk, cos_t, sin_t)
            with span("attention"):
                tv, iv = v[:, :s_txt], v[:, s_txt:]
                o, _ = layer_attn(iq, ik, iv, cm.layer_of(seg_state, seg_l), joint_q=tq, joint_k=tk,
                                  joint_v=tv)
            with span("ffn_gate"):
                x = out_proj(p, o, xn, x, g)
                img, txt = x[:, s_txt:], x[:, :s_txt]
        return img, txt, attn_state


def flux_head(params, img, temb, cfg: FluxConfig):
    """AdaLN-Continuous norm_out + proj_out -> velocity tokens."""
    with span("head"):
        scale, shift = _mod(params["norm_out_mod"], temb, 2)
        return cm.linear(params["proj_out"], _modulate(img, shift, scale))


def flux_forward(
    params,
    img: torch.Tensor,
    txt: torch.Tensor,
    pooled: torch.Tensor,
    t: torch.Tensor,
    guidance: Optional[torch.Tensor],
    cfg: FluxConfig,
    *,
    img_rope: Tuple[torch.Tensor, torch.Tensor],
    txt_rope: Tuple[torch.Tensor, torch.Tensor],
    attn=SingleDeviceAttn(),
    attn_state_double=(),
    attn_state_single=(),
    attn_single=None,
    tp_axis: Optional[str] = None,
    cache_cfg=None,
    cache_state=None,
    cache_force=None,
    pp_stages: int = 1,
    mesh=None,
):
    """FLUX denoiser on this rank's image tokens.

    img (B, S_img_local, in_channels) packed latent tokens; txt (B, S_txt,
    text_dim) T5 states; pooled (B, pooled_dim); t (B,) timesteps in train
    units (sigma * 1000); guidance (B,) or None; img_rope / txt_rope (cos,
    sin) tables of the local image tokens and the text tokens
    (:func:`cm.rope_frequencies`).  ``attn_single`` is the single family's
    strategy (default ``attn``); per-layer plans give each family a tuple of
    ``(strategy, n_layers)`` segments and a tuple of states.

    Returns (velocity (B, S_img_local, in_channels), state_double,
    state_single), and the new cache state with ``cache_cfg`` (TeaCache /
    FBCache: the first double block runs, ``should_skip`` decides from its
    probe with one host read, and the rest of the stack either runs and
    refreshes the cached image residual or is replaced by it; ``mesh`` is
    this rank's mesh when ``cache_cfg.sp_axes`` sums the probe over ranks).

    ``pp_stages`` > 1: sync PipeFusion over the pp axis of ``mesh``, the
    double blocks as one pipeline and the single blocks as the next (each
    stack this stage's layers, as the JAX package shards them).
    ``tp_axis``: the ffns sum over that axis of ``mesh``.
    """
    if (pp_stages > 1 or tp_axis is not None) and mesh is None:
        raise ValueError(f"PipeFusion ({pp_stages} stages) or TP ({tp_axis}) needs this rank's mesh")
    if pp_stages > 1 and cache_cfg is not None and cache_cfg.mode != "none":
        raise ValueError(PIPEFUSION_REFUSAL)
    with span("embed"):
        img = cm.linear(params["x_embedder"], img)
        txt = cm.linear(params["context_embedder"], txt)
        temb = flux_time_embed(params, pooled, t, guidance, cfg)
    rope = dict(img_rope=img_rope, txt_rope=txt_rope, tp_axis=tp_axis, mesh=mesh)

    if cache_cfg is not None and cache_cfg.mode != "none":
        # skipped blocks would desync a strategy's state
        if cm.has_tensors(attn_state_double) or cm.has_tensors(attn_state_single):
            raise ValueError("cache acceleration is incompatible with a stateful attention strategy")
        blocks = params["double_blocks"]
        mod0 = cm.linear(cm.layer_of(blocks["img_mod"], 0), cm.silu(temb))
        sh0, sc0 = mod0[:, None, : cfg.dim], mod0[:, None, cfg.dim: 2 * cfg.dim]
        probe_in = _modulate(img, sh0, sc0)
        img1, txt1, _ = flux_double_scan(cm.layer_of(blocks, slice(0, 1)), img, txt, temb, cfg, attn=attn,
                                         **rope)
        # FBCache probes the first block's residual, TeaCache its modulated input
        probe = (img1 - img) if cache_cfg.mode == "fbcache" else probe_in
        skip, accum = should_skip(cache_cfg, cache_state, probe, force_compute=cache_force, mesh=mesh)
        skipped = bool(skip)  # the step's one host read
        if skipped:
            img, residual = img1 + cache_state.residual.to(img1.dtype), cache_state.residual
        else:
            img2, txt2, _ = flux_double_scan(cm.layer_of(blocks, slice(1, None)), img1, txt1, temb, cfg,
                                             attn=attn, **rope)
            img, _, _ = flux_single_scan(params["single_blocks"], img2, txt2, temb, cfg, attn=attn, **rope)
            residual = (img - img1).to(cache_state.residual.dtype)
        new_cache = CacheAccelState(
            prev_probe=next_probe(cache_cfg, cache_state, probe, skip),
            residual=residual,
            accum=accum,
            has_prev=torch.ones_like(cache_state.has_prev),
            skips=cache_state.skips + int(skipped),
        )
        return flux_head(params, img, temb, cfg), attn_state_double, attn_state_single, new_cache

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

    img, txt, state_double = flux_double_scan(params["double_blocks"], img, txt, temb, cfg, attn=attn,
                                              attn_state=attn_state_double, **rope)
    img, txt, state_single = flux_single_scan(params["single_blocks"], img, txt, temb, cfg, attn=attn_s,
                                              attn_state=attn_state_single, **rope)
    return flux_head(params, img, temb, cfg), state_double, state_single
