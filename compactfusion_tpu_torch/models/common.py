"""Functional building blocks shared by the DiT backbones
(counterpart of ``compactfusion_tpu/models/common.py``).

Parameters are plain dicts of tensors in the JAX layouts: a linear weight is
``(d_in, d_out)`` and ``y = x @ w + b``.  Norms keep fp32 statistics and
return the input dtype, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers (torch.Generator draws; the tensors live on its device)
# ---------------------------------------------------------------------------


def trunc_normal(generator: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2] (the JAX ``truncated_normal(-2, 2)``) times
    ``std``, drawn in fp32 on the generator's device."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def init_linear(generator, d_in: int, d_out: int, bias: bool = True,
                dtype=torch.bfloat16, stack=()):
    """``stack`` prepends leading axes (the stacked layer axis of a block)."""
    p = {"w": trunc_normal(generator, (*stack, d_in, d_out), 0.02, dtype)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=generator.device)
    return p


def init_rmsnorm(dim: int, dtype=torch.bfloat16, device=None, stack=()):
    return {"g": torch.ones((*stack, dim), dtype=dtype, device=device)}


def init_layernorm(dim: int, dtype=torch.bfloat16, device=None, stack=()):
    return {"g": torch.ones((*stack, dim), dtype=dtype, device=device),
            "b": torch.zeros((*stack, dim), dtype=dtype, device=device)}


def init_timestep_embedder(generator, dim: int, hidden: int, dtype=torch.bfloat16):
    return {
        "fc1": init_linear(generator, dim, hidden, dtype=dtype),
        "fc2": init_linear(generator, hidden, hidden, dtype=dtype),
    }


def init_ffn(generator, dim: int, hidden: int, bias: bool = True,
             dtype=torch.bfloat16, stack=()):
    return {
        "fc1": init_linear(generator, dim, hidden, bias=bias, dtype=dtype, stack=stack),
        "fc2": init_linear(generator, hidden, dim, bias=bias, dtype=dtype, stack=stack),
    }


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def dequant_weight(p, dtype) -> torch.Tensor:
    """A linear's weight: ``w``, or the int8 form of
    :func:`quantize_params_int8` dequantized to ``dtype`` (int8 codes times
    the fp32 per-output-channel scale, then one rounding to ``dtype``)."""
    if "w_q" in p:
        return (p["w_q"].float() * p["scale"]).to(dtype)
    return p["w"]


def weight_shape(p) -> torch.Size:
    """The shape of a linear's weight in either form (``w`` or ``w_q``);
    a stacked block's leading axis is its depth."""
    return (p["w_q"] if "w_q" in p else p["w"]).shape


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with JAX dtype promotion (an fp32 input against bf16
    weights computes in fp32, as ``jnp.matmul`` does); an int8 weight is
    dequantized to the input's dtype, as the JAX ``linear`` does."""
    if "w_q" in p:
        y = x @ dequant_weight(p, x.dtype)
    else:
        w = p["w"]
        dt = torch.promote_types(x.dtype, w.dtype)
        y = x.to(dt) @ w.to(dt)
    if "b" in p:
        y = y + p["b"]
    return y


def quantize_params_int8(params, keys=None):
    """Per-output-channel symmetric int8 weight quantization of every linear
    in the tree (``{"w", "b"?}`` -> ``{"w_q", "scale", "b"?}``), as the JAX
    ``quantize_params_int8``: the scale is the largest magnitude over the
    input axis (second to last, so stacked (L, in, out) weights get one per
    layer and output channel) over 127, 1 where that is 0, and the codes
    round half to even.  ``keys``: the top-level keys to quantize (the
    block stacks); the rest passes through."""

    def quant(w):
        w32 = w.to(torch.float32, copy=True)  # divided in place below, never the caller's weight
        scale = w32.abs().amax(dim=-2, keepdim=True) / 127.0
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        # in place on the fp32 copy: one temporary the size of a stack
        q = w32.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
        return {"w_q": q, "scale": scale}

    def walk(p):
        if isinstance(p, dict):
            if "w" in p and getattr(p["w"], "ndim", 0) >= 2:
                out = quant(p["w"])
                if "b" in p:
                    out["b"] = p["b"]
                return out
            return {k: walk(v) for k, v in p.items()}
        return p

    if keys is None:
        return walk(params)
    return {k: (walk(v) if k in set(keys) else v) for k, v in params.items()}


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if "g" in p:
        y = y * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis in fp32, cast back to x.dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if p and "g" in p:
        y = y * p["g"].float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


# ---------------------------------------------------------------------------
# timestep / positional embeddings
# ---------------------------------------------------------------------------


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                         flip_sin_to_cos: bool = True) -> torch.Tensor:
    """DDPM sinusoidal timestep embedding -> (B, dim) fp32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def timestep_embedder(p, t: torch.Tensor, dim: int) -> torch.Tensor:
    """sinusoidal -> MLP (the diffusers ``TimestepEmbedding`` shape)."""
    w1 = p["fc1"].get("w", p["fc1"].get("w_q"))
    emb = sinusoidal_embedding(t, dim).to(torch.bfloat16 if w1.dtype == torch.int8 else w1.dtype)
    return linear(p["fc2"], silu(linear(p["fc1"], emb)))


def mlp_embedder(p, x: torch.Tensor) -> torch.Tensor:
    """MLP on a raw conditioning vector (FLUX's pooled CLIP embedding)."""
    return linear(p["fc2"], silu(linear(p["fc1"], x)))


def patch_positions_2d(h_patches: int, w_patches: int, device=None) -> torch.Tensor:
    """(H*W, 2) int64 row/col indices in raster order."""
    rows = torch.arange(h_patches, device=device).repeat_interleave(w_patches)
    cols = torch.arange(w_patches, device=device).repeat(h_patches)
    return torch.stack([rows, cols], dim=-1)


def _sincos_embed_1d(x: torch.Tensor, d: int) -> torch.Tensor:
    """sin and cos of the fp32 arguments x * omega, each evaluated in float64
    by numpy (one thread) and rounded to fp32 once."""
    omega = torch.arange(d // 2, dtype=torch.float32) / (d / 2.0)
    omega = 1.0 / (10000.0**omega)
    out = (x[:, None] * omega[None, :]).numpy().astype(np.float64)
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=-1).astype(np.float32))


def sincos_pos_embed_2d(dim: int, h_patches: int, w_patches: int,
                        base_size: Optional[int] = None,
                        interpolation_scale: float = 1.0) -> torch.Tensor:
    """2D sin-cos positional table (H*W, dim), raster order, fp32, on the CPU.

    The first half of the channels embeds the column coordinate (diffusers
    ``get_2d_sincos_pos_embed``).  The arguments are the fp32 products the
    JAX package forms; their sin and cos are taken in float64 on one thread
    (:func:`_sincos_embed_1d`), so every process gets the same bits: torch's
    fp32 sin/cos over the whole table, on a busy host, gave a table that
    differed in a few elements between processes, and with it requests of
    one pipeline, or ranks of one ring, that disagreed."""
    rows = torch.arange(h_patches).repeat_interleave(w_patches).float()
    cols = torch.arange(w_patches).repeat(h_patches).float()
    if base_size is not None:
        rows = rows / (h_patches / base_size) / interpolation_scale
        cols = cols / (w_patches / base_size) / interpolation_scale
    half = dim // 2
    return torch.cat([_sincos_embed_1d(cols, half), _sincos_embed_1d(rows, half)], dim=-1)


def cropped_pos_embed_2d(dim: int, h_patches: int, w_patches: int, max_size: int, base_size: int,
                         interpolation_scale: float = 1.0) -> torch.Tensor:
    """SD3's positional table (H*W, dim), fp32 on the CPU: the (max_size,
    max_size) table at ``base_size`` scaling, center-cropped to the grid
    (diffusers ``PatchEmbed.cropped_pos_embed``).  The positions are the
    JAX package's fp32 quotients; sin and cos as :func:`sincos_pos_embed_2d`
    takes them."""
    coords = torch.arange(max_size, dtype=torch.float32) / (max_size / base_size) / interpolation_scale
    top, left = (max_size - h_patches) // 2, (max_size - w_patches) // 2
    rows = coords[top:top + h_patches].repeat_interleave(w_patches)
    cols = coords[left:left + w_patches].repeat(h_patches)
    half = dim // 2
    return torch.cat([_sincos_embed_1d(cols, half), _sincos_embed_1d(rows, half)], dim=-1)


# ---------------------------------------------------------------------------
# RoPE (FLUX style, axis-split rotary)
# ---------------------------------------------------------------------------


def rope_frequencies(positions: torch.Tensor, axes_dim: Tuple[int, ...],
                     theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-axis RoPE tables: ``positions`` (S, n_axes) integer coordinates
    per token (FLUX: [t, h, w]), ``axes_dim`` the head-dim split per axis
    (FLUX: (16, 56, 56)) -> (cos, sin), each (S, head_dim/2) fp32 on the
    positions' device."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        pos = positions[:, i].float()
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) / d))
        angles = pos[:, None] * freqs[None, :]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, S, H, D) by per-token (S, D/2) tables, interleaved pairs
    (2i, 2i+1), in fp32; returns x.dtype."""
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)


def rope_half_tables(cos: torch.Tensor, sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, D/2) tables -> the (S, D) form :func:`apply_rope_half` takes."""
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def apply_rope_half(x: torch.Tensor, cos_f: torch.Tensor, sin_f: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope on (B, S, H, D): dim pairs (i, i + D/2), in fp32;
    returns x.dtype.  Scores equal :func:`apply_rope`'s once the Wq/Wk
    columns and qk-norm gains are permuted per head by
    :func:`rope_half_perm` (the FLUX converters do)."""
    x32 = x.float()
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x32[..., d2:], x32[..., :d2]], dim=-1)
    return (x32 * cos_f[None, :, None, :] + rot * sin_f[None, :, None, :]).to(x.dtype)


def rope_half_perm(dh: int) -> np.ndarray:
    """Head-dim permutation from the interleaved-pair rope layout to the
    rotate-half one: new[j] = old[2j], new[D/2 + j] = old[2j + 1]."""
    return np.concatenate([np.arange(0, dh, 2), np.arange(1, dh, 2)])


# ---------------------------------------------------------------------------
# stacked layers
# ---------------------------------------------------------------------------


def layer_of(tree, l):
    """Layer ``l`` (an index, or a slice of layers) of a tree (dicts, tuples,
    NamedTuples) of layer-stacked tensors, as views; ``None`` stays
    ``None``."""
    if isinstance(tree, dict):
        return {k: layer_of(v, l) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[l]
    parts = [layer_of(t, l) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def layer_strategies(attn, attn_state, depth: int):
    """(strategy, its state, the layer's index in that state) for each of
    ``depth`` layers: one strategy for every layer, or ``attn`` a tuple of
    ``(strategy, n_layers)`` segments (a per-layer compression plan) with
    ``attn_state`` the tuple of their states."""
    if not isinstance(attn, (tuple, list)):
        return [(attn, attn_state, l) for l in range(depth)]
    layers = [(seg_attn, seg_state, l) for (seg_attn, n_l), seg_state in zip(attn, attn_state)
              for l in range(n_l)]
    if len(layers) != depth:
        raise ValueError(f"layer segments cover {len(layers)} of {depth} blocks")
    return layers


def to_device(tree, device):
    """A tree (dicts, lists) of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def has_tensors(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    if isinstance(tree, dict):
        tree = tree.values()
    return tree is not None and any(has_tensors(t) for t in tree)


# ---------------------------------------------------------------------------
# patchify / unpatchify
# ---------------------------------------------------------------------------


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C) raster order."""
    b, h, w, c = x.shape
    hp, wp = h // patch, w // patch
    x = x.reshape(b, hp, patch, wp, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * wp, patch * patch * c)


def unpatchify(x: torch.Tensor, patch: int, hp: int, wp: int, channels: int) -> torch.Tensor:
    """(B, hp*wp, p*p*C) -> (B, hp*p, wp*p, C)."""
    b = x.shape[0]
    x = x.reshape(b, hp, wp, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * patch, wp * patch, channels)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def ffn(p, x: torch.Tensor, act=gelu, tp_axis: Optional[str] = None, mesh=None) -> torch.Tensor:
    """GELU MLP.  With ``tp_axis``: this rank's fc1 columns and fc2 rows
    (``parallel/tp.py``), the partial products summed over the tp axis of
    ``mesh`` (``Mesh.all_reduce_sum``), fc2's bias added after the sum, as
    the JAX ``ffn(tp_axis=)`` does (reference ``layers/feedforward.py``)."""
    h = act(linear(p["fc1"], x))
    if tp_axis is None:
        return linear(p["fc2"], h)
    if mesh is None:
        raise ValueError(f"a tensor-parallel ffn ({tp_axis!r}) needs this rank's mesh")
    w = dequant_weight(p["fc2"], h.dtype)
    dt = torch.promote_types(h.dtype, w.dtype)
    y = mesh.all_reduce_sum(h.to(dt) @ w.to(dt), tp_axis)
    if "b" in p["fc2"]:
        y = y + p["fc2"]["b"]
    return y
