"""PixArt-alpha DiT backbone (counterpart of ``compactfusion_tpu/models/pixart.py``).

Patch embed + T5 caption projection, N blocks of [AdaLN-single
self-attention, cross-attention to text, AdaLN-single GELU MLP], AdaLN final
norm and a linear head predicting (noise, variance) per patch.  Block
parameters are stacked on a leading layer axis, as in ``init_pixart`` of the
JAX package, and the forward is a Python loop over that axis: the tree's
own layers, which under PipeFusion are this stage's (``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from compactfusion_tpu_torch.cache.accel import PIPEFUSION_REFUSAL, CacheAccelState, next_probe, should_skip
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.ops.attention import sdpa
from compactfusion_tpu_torch.parallel.pipefusion import pipefusion_blocks


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    dim: int = 1152
    depth: int = 28
    heads: int = 16
    patch: int = 2
    in_channels: int = 4
    out_channels: int = 8  # 4 noise + 4 learned-variance
    text_dim: int = 4096  # T5-XXL
    ffn_mult: int = 4
    sample_size: int = 64  # latent H=W for 512px
    interpolation_scale: float = 1.0
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads

    @property
    def base_size(self):
        return self.sample_size // self.patch


def pixart_alpha_512() -> PixArtConfig:
    return PixArtConfig()


def pixart_sigma_1024() -> PixArtConfig:
    """PixArt-Sigma-XL-2-1024-MS: the alpha backbone at 128 x 128 latents,
    positions scaled by interpolation_scale 2."""
    return PixArtConfig(sample_size=128, interpolation_scale=2.0)


def pixart_sigma_2k() -> PixArtConfig:
    """PixArt-Sigma-XL-2-2K-MS (the reference's DiTFastAttn target)."""
    return PixArtConfig(sample_size=256, interpolation_scale=4.0)


def pixart_tiny() -> PixArtConfig:
    """Scaled-down config for tests."""
    return PixArtConfig(dim=64, depth=2, heads=4, text_dim=32, sample_size=8)


def init_pixart(generator: torch.Generator, cfg: PixArtConfig):
    """Random init on the generator's device; the block stack has a leading
    layer axis (same tree as the JAX ``init_pixart``, other random draws)."""
    d, dt, L = cfg.dim, cfg.dtype, (cfg.depth,)
    dev = generator.device
    blocks = {
        "scale_shift_table": torch.zeros((cfg.depth, 6, d), dtype=dt, device=dev),
        "attn_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "cross_q": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "cross_kv": cm.init_linear(generator, d, 2 * d, dtype=dt, stack=L),
        "cross_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "ffn": cm.init_ffn(generator, d, cfg.ffn_mult * d, dtype=dt, stack=L),
    }
    return {
        "patch_embed": cm.init_linear(generator, cfg.patch * cfg.patch * cfg.in_channels, d, dtype=dt),
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "adaln_single": cm.init_linear(generator, d, 6 * d, dtype=dt),
        "caption_fc1": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        "caption_fc2": cm.init_linear(generator, d, d, dtype=dt),
        "blocks": blocks,
        "final_scale_shift": torch.zeros((2, d), dtype=dt, device=dev),
        "proj_out": cm.init_linear(generator, d, cfg.patch * cfg.patch * cfg.out_channels, dtype=dt),
    }


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _unheads(x):
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


def pixart_embed(params, x, pos_embed, cfg: PixArtConfig):
    """Patch-embed + positional table -> hidden tokens (B, S, dim)."""
    return cm.linear(params["patch_embed"], x) + pos_embed.to(cfg.dtype)[None]


def pixart_head(params, x, temb, cfg: PixArtConfig):
    """Final AdaLN + projection (diffusers PixArt norm_out semantics)."""
    fin = params["final_scale_shift"][None] + temb[:, None, :].repeat(1, 2, 1)
    shift, scale = fin[:, 0][:, None], fin[:, 1][:, None]
    x = cm.layernorm({}, x) * (1 + scale) + shift
    return cm.linear(params["proj_out"], x)


def precompute_text_kv(params, text: torch.Tensor) -> torch.Tensor:
    """The step-invariant text path, once per image: caption MLP, then every
    block's ``cross_kv`` -> (L, B, S_text, 2*dim)."""
    text = cm.linear(params["caption_fc2"], cm.gelu(cm.linear(params["caption_fc1"], text)))
    kv = params["blocks"]["cross_kv"]
    return torch.stack([cm.linear(cm.layer_of(kv, l), text) for l in range(cm.weight_shape(kv)[0])])


def pixart_forward(
    params,
    x: torch.Tensor,
    t: torch.Tensor,
    text: Optional[torch.Tensor],
    cfg: PixArtConfig,
    *,
    pos_embed: torch.Tensor,
    attn=SingleDeviceAttn(),
    attn_state=(),
    text_mask: Optional[torch.Tensor] = None,
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    cache_cfg=None,
    cache_state=None,
    cache_force=None,
    text_kv: Optional[torch.Tensor] = None,
    x_is_hidden: bool = False,
    return_hidden: bool = False,
    mesh=None,
):
    """Denoiser forward on patchified latent tokens.

    x: (B, S, p*p*C), or the hidden tokens (B, S, dim) with ``x_is_hidden``
    (the patch pipeline's later stages); t: (B,) timesteps; text: (B,
    S_text, text_dim) (ignored when ``text_kv`` from
    :func:`precompute_text_kv` is given); pos_embed (S, dim); attn_state:
    per-layer state stacked on a leading layer axis (updated in place by the
    compressing strategies).  A per-layer compression plan passes ``attn``
    as a tuple of ``(strategy, n_layers)`` segments covering the blocks in
    order, and ``attn_state`` as a tuple of their states.  Returns (out (B,
    S, p*p*out_channels), attn_state), out the hidden tokens with
    ``return_hidden``.  The blocks are the tree's layers (this stage's under
    PipeFusion).

    ``pp_stages`` > 1: sync PipeFusion over the pp axis of ``mesh``
    (``parallel/pipefusion.py``).  ``tp_axis``: each ffn sums its partial
    products over that axis of ``mesh``.

    ``cache_cfg`` (``CacheAccelConfig`` with a mode other than "none"):
    TeaCache/FBCache.  Block 0 runs, ``should_skip`` decides from its probe
    (one host read of a 0-dim tensor, the eager ``lax.cond``), and blocks
    1.. either run and refresh the cached residual or are replaced by it;
    ``cache_force`` forces the full run; ``mesh`` is this rank's mesh when
    ``cache_cfg.sp_axes`` sums the probe over ranks.  Then it returns (out,
    attn_state, new cache_state).
    """
    use_cache = cache_cfg is not None and cache_cfg.mode != "none"
    if pp_stages > 1 and mesh is None:
        raise ValueError(f"PipeFusion over {pp_stages} stages needs this rank's mesh")
    blocks = params["blocks"]
    depth = cm.weight_shape(blocks["attn_qkv"])[0]
    layers = cm.layer_strategies(attn, attn_state, depth)
    d, h = cfg.dim, cfg.heads

    if not x_is_hidden:
        x = pixart_embed(params, x, pos_embed, cfg)
    temb = cm.timestep_embedder(params["t_embed"], t, 256)  # (B, d)
    mod6 = cm.linear(params["adaln_single"], cm.silu(temb)).reshape(-1, 6, d)

    if text_kv is None:
        text = cm.linear(params["caption_fc2"], cm.gelu(cm.linear(params["caption_fc1"], text)))
    # text masks are contiguous padding prefixes: a per-batch length
    kv_lens = None if text_mask is None else text_mask.sum(dim=-1).to(torch.int32)

    def block(l, x):
        layer_attn, seg_state, seg_l = layers[l]
        p = cm.layer_of(blocks, l)
        table = p["scale_shift_table"][None] + mod6  # (B, 6, d)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = [table[:, i][:, None] for i in range(6)]

        # self attention (AdaLN-single)
        xn = cm.layernorm({}, x) * (1 + sc_a) + sh_a
        q, k, v = cm.linear(p["attn_qkv"], xn).split(d, dim=-1)
        o, _ = layer_attn(_heads(q, h), _heads(k, h), _heads(v, h), cm.layer_of(seg_state, seg_l))
        x = x + g_a * cm.linear(p["attn_out"], _unheads(o))

        # cross attention to text
        q = cm.linear(p["cross_q"], x)
        kv = cm.linear(p["cross_kv"], text) if text_kv is None else text_kv[l]
        k, v = kv.split(d, dim=-1)
        o = _cross_attn(_heads(q, h), _heads(k, h), _heads(v, h), None, kv_lens=kv_lens)
        x = x + cm.linear(p["cross_out"], _unheads(o))

        # mlp
        xn = cm.layernorm({}, x) * (1 + sc_m) + sh_m
        return x + g_m * cm.ffn(p["ffn"], xn, tp_axis=tp_axis, mesh=mesh)

    def run_local(x):
        for l in range(depth):
            x = block(l, x)
        return x

    if not use_cache:
        x = pipefusion_blocks(run_local, x, mesh) if pp_stages > 1 else run_local(x)
        return (x if return_hidden else pixart_head(params, x, temb, cfg)), attn_state

    # TeaCache / FBCache: skipped blocks would desync a strategy's state
    if cm.has_tensors(attn_state):
        raise ValueError("cache acceleration is incompatible with a stateful attention strategy")
    if pp_stages > 1:
        raise ValueError(PIPEFUSION_REFUSAL)
    table0 = blocks["scale_shift_table"][0][None] + mod6
    probe_in = cm.layernorm({}, x) * (1 + table0[:, 1][:, None]) + table0[:, 0][:, None]
    x1 = block(0, x)
    # FBCache probes block 0's residual, TeaCache its modulated input
    probe = (x1 - x) if cache_cfg.mode == "fbcache" else probe_in
    skip, accum = should_skip(cache_cfg, cache_state, probe, force_compute=cache_force, mesh=mesh)
    skipped = bool(skip)  # the step's one host read
    if skipped:
        x, residual = x1 + cache_state.residual.to(x1.dtype), cache_state.residual
    else:
        x = x1
        for l in range(1, depth):
            x = block(l, x)
        residual = (x - x1).to(cache_state.residual.dtype)
    new_cache = CacheAccelState(
        prev_probe=next_probe(cache_cfg, cache_state, probe, skip),
        residual=residual,
        accum=accum,
        has_prev=torch.ones_like(cache_state.has_prev),
        skips=cache_state.skips + int(skipped),
    )
    return (x if return_hidden else pixart_head(params, x, temb, cfg)), attn_state, new_cache


def _cross_attn(q, k, v, mask, kv_lens=None):
    """Cross-attention to the text: ``kv_lens`` (B,) covers the contiguous
    text padding masks and takes ``sdpa``'s no-LSE route (``ops/attention.py::
    _attn_nolse``, as the JAX ``sdpa`` takes ``_xla_attn_nolse``); an
    arbitrary (B, 1, 1, Sk) bool ``mask`` takes its math path.  Both return 0
    for a fully masked row."""
    return sdpa(q, k, v, mask=None if kv_lens is not None else mask, kv_lens=kv_lens)
