"""Step-Video-T2V backbone with full tensor parallelism
(counterpart of ``compactfusion_tpu/models/stepvideo.py``).

A 30B-class video DiT whose whole transformer is tensor-parallel: the
attention projections split by heads (column-parallel in, row-parallel out
with one all-reduce), the bias-free FFN Megatron-split.  The fused qkv
weight keeps the JAX layout ``(d, 3, H, hd)``, so the head axis is an axis
of its own that ``parallel/tp.py::stepvideo_local_params`` cuts; the output
projections are ``(H, hd, d)``.  Block parameters are stacked on a leading
layer axis and the forward is a Python loop over it.

The rope is a half-split rotation per axis chunk (64 / 32 / 32 of the head
dim over (frame, row, column)): frequencies ``cat(freqs, freqs)`` and
``rotate_half`` inside each chunk, not the interleaved pairs of FLUX or
CogVideoX.

Seeded weights (:func:`init_stepvideo`) are drawn one layer at a time into
preallocated stacks: at full size one fp32 draw of a whole ``fc1`` stack
(48 x 6144 x 24576) would take 29 GB beside the 58.7 GB of bf16 weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.models.cogvideox import video_positions
from compactfusion_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class StepVideoConfig:
    dim: int = 6144
    depth: int = 48
    heads: int = 48
    patch: int = 2
    in_channels: int = 64
    text_dim: int = 6144
    ffn_mult: int = 4
    #: rope channel split over (f, h, w) of the head dim 128
    axes_dim: Tuple[int, ...] = (64, 32, 32)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads


def stepvideo_t2v() -> StepVideoConfig:
    return StepVideoConfig()


def stepvideo_tiny() -> StepVideoConfig:
    return StepVideoConfig(dim=64, depth=2, heads=4, in_channels=16, text_dim=32, axes_dim=(8, 4, 4))


def stepvideo_rope_tables(frames: int, hp: int, wp: int, ch_split: Tuple[int, ...], theta: float = 1e4,
                          device=None):
    """Per-axis half-split rope tables: a list of (cos, sin), each (S,
    D_axis) fp32 on ``device``, positions in frame-major raster order.  The
    angles are fp32 products, as in the JAX package; their cos and sin are
    taken in float64 by numpy and rounded to fp32 once, so every process
    gets the same bits."""
    pos = video_positions(frames, hp, wp).numpy()  # (S, 3) = (f, h, w)
    tables = []
    for i, dax in enumerate(ch_split):
        inv = 1.0 / theta ** (np.arange(0, dax, 2, dtype=np.float32) / np.float32(dax))
        ang = pos[:, i].astype(np.float32)[:, None] * inv.astype(np.float32)[None]
        ang = np.concatenate([ang, ang], axis=-1).astype(np.float64)
        tables.append(tuple(torch.from_numpy(f(ang).astype(np.float32)).to(device) for f in (np.cos, np.sin)))
    return tables


def _rope_operands(tables, ch_split, head_dim: int):
    """(cos, signed sin, rotate-half index) over the whole head dim: chunk
    [off, off + a) rotates its halves, so the rotated element i takes
    -x[i + a/2] in the first half and x[i - a/2] in the second; the sign
    rides on the sin table."""
    idx, cos, sin = [], [], []
    off = 0
    for (c, s), dax in zip(tables, ch_split):
        h = dax // 2
        idx += list(range(off + h, off + dax)) + list(range(off, off + h))
        cos.append(c)
        sin += [-s[:, :h], s[:, h:]]
        off += dax
    if off != head_dim:
        raise ValueError(f"rope chunks {tuple(ch_split)} cover {off} of head dim {head_dim}")
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1), torch.tensor(idx, device=cos[0].device)


def apply_rope_3d_half(x: torch.Tensor, tables, ch_split) -> torch.Tensor:
    """Rotate (B, S, H, D) per channel chunk with the half-split tables of
    :func:`stepvideo_rope_tables`, in fp32; returns x.dtype.  Per element
    ``c * cos + rot * sin`` with ``rot = cat(-x2, x1)``, the JAX package's
    arithmetic (a negation is exact)."""
    cos, sin, idx = _rope_operands(tables, ch_split, x.shape[-1])
    x32 = x.float()
    return (x32 * cos[None, :, None, :] + x32[..., idx] * sin[None, :, None, :]).to(x.dtype)


def _draw_stack(generator: torch.Generator, depth: int, shape, dtype) -> torch.Tensor:
    """``depth`` truncated-normal (std 0.02) layers stacked, drawn one layer
    at a time into a preallocated stack (one fp32 layer at a time)."""
    out = torch.empty((depth, *shape), dtype=dtype, device=generator.device)
    for l in range(depth):
        out[l] = cm.trunc_normal(generator, shape, 0.02, dtype)
    return out


def init_stepvideo(generator: torch.Generator, cfg: StepVideoConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_stepvideo`` (other draws), the blocks stacked on a leading layer
    axis and drawn layer by layer (:func:`_draw_stack`)."""
    d, dt, h, hd, L = cfg.dim, cfg.dtype, cfg.heads, cfg.head_dim, cfg.depth
    dev = generator.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def heads_in(n):  # fused n-way projection (d, n, H, hd)
        return {"w": _draw_stack(generator, L, (d, n, h, hd), dt), "b": zeros(L, n, h, hd)}

    def heads_out():
        return {"w": _draw_stack(generator, L, (h, hd, d), dt), "b": zeros(L, d)}

    def rms():
        return cm.init_rmsnorm(hd, dt, dev, (L,))

    blocks = {
        "scale_shift_table": zeros(L, 6, d),
        "norm1": cm.init_layernorm(d, dt, dev, (L,)),
        "qkv": heads_in(3),
        "q_norm": rms(),
        "k_norm": rms(),
        "attn_out": heads_out(),
        "cross_q": heads_in(1),
        "cross_kv": heads_in(2),
        "cross_q_norm": rms(),
        "cross_k_norm": rms(),
        "cross_out": heads_out(),
        "norm2": cm.init_layernorm(d, dt, dev, (L,)),
        # bias-free FeedForward: the checkpoint ships no FFN biases
        "ffn": {"fc1": {"w": _draw_stack(generator, L, (d, cfg.ffn_mult * d), dt)},
                "fc2": {"w": _draw_stack(generator, L, (cfg.ffn_mult * d, d), dt)}},
    }
    return {
        "patch_embed": cm.init_linear(generator, cfg.in_channels, d, dtype=dt),
        # caption projection: linear -> gelu(tanh) -> linear
        "text_proj": {"fc1": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
                      "fc2": cm.init_linear(generator, d, d, dtype=dt)},
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "adaln": cm.init_linear(generator, d, 6 * d, dtype=dt),
        "blocks": blocks,
        # PixArt-style head: scale_shift_table + embedded timestep
        "final_scale_shift": zeros(2, d),
        "proj_out": cm.init_linear(generator, d, cfg.in_channels, dtype=dt),
    }


def _qkv_proj(p, x):
    """(B, S, D) @ (D, n, Hl, hd) + (n, Hl, hd) -> n tensors (B, S, Hl, hd)
    (views of one product)."""
    w = p["w"]
    d, n, hl, hd = w.shape
    y = cm.linear({"w": w.reshape(d, n * hl * hd), "b": p["b"].reshape(-1)}, x)
    y = y.reshape(*x.shape[:-1], n, hl, hd)
    return tuple(y[..., i, :, :] for i in range(n))


def _head_out(p, o, tp_axis, mesh):
    """(B, S, Hl, hd) @ (Hl, hd, D) -> (B, S, D): under TP the row-parallel
    partial products sum over the tp axis before the bias is added."""
    w = p["w"]
    hl, hd, d = w.shape
    dt = torch.promote_types(o.dtype, w.dtype)
    y = o.reshape(*o.shape[:-2], hl * hd).to(dt) @ w.reshape(hl * hd, d).to(dt)
    if tp_axis is not None:
        y = mesh.all_reduce_sum(y, tp_axis)
    return y + p["b"]


def stepvideo_forward(
    params,
    video: torch.Tensor,
    txt: torch.Tensor,
    t: torch.Tensor,
    cfg: StepVideoConfig,
    *,
    video_rope,
    attn=SingleDeviceAttn(),
    attn_state=(),
    tp_axis: Optional[str] = None,
    mesh=None,
):
    """Step-Video denoiser on this rank's video tokens.

    video (B, S_local, in_channels); txt (B, S_txt, text_dim); t (B,);
    video_rope: the per-axis (cos, sin) tables of :func:`stepvideo_rope_tables`
    sliced to the local tokens.  ``attn`` is one strategy or a tuple of
    ``(strategy, n_layers)`` segments with ``attn_state`` the tuple of their
    states, updated in place.  With ``tp_axis`` every attention runs on this
    rank's heads (``parallel/tp.py::stepvideo_local_params``) and the output
    projections and the ffn sum over that axis of ``mesh``; Ulysses splits
    the local heads further.  Returns (the velocity (B, S_local,
    in_channels), attn_state)."""
    if tp_axis is not None and mesh is None:
        raise ValueError(f"TP ({tp_axis}) needs this rank's mesh")
    d = cfg.dim
    x = cm.linear(params["patch_embed"], video)
    txt = cm.linear(params["text_proj"]["fc2"], cm.gelu(cm.linear(params["text_proj"]["fc1"], txt)))
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    mod6 = cm.linear(params["adaln"], cm.silu(temb)).reshape(-1, 6, d)
    blocks = params["blocks"]
    depth = blocks["scale_shift_table"].shape[0]

    def block(p, layer_attn, state, x):
        table = p["scale_shift_table"][None] + mod6
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = (table[:, i][:, None] for i in range(6))
        # affine norm1 (eps 1e-5), modulate, qk-normed rope'd self-attention,
        # gated residual
        xn = cm.layernorm(p["norm1"], x, eps=1e-5) * (1 + sc_a) + sh_a
        q, k, v = _qkv_proj(p["qkv"], xn)
        q = apply_rope_3d_half(cm.rmsnorm(p["q_norm"], q), video_rope, cfg.axes_dim)
        k = apply_rope_3d_half(cm.rmsnorm(p["k_norm"], k), video_rope, cfg.axes_dim)
        o, _ = layer_attn(q, k, v, state)
        x = x + g_a * _head_out(p["attn_out"], o, tp_axis, mesh)
        # cross-attention on the raw stream, ungated
        (q,) = _qkv_proj(p["cross_q"], x)
        kt, vt = _qkv_proj(p["cross_kv"], txt)
        o = sdpa(cm.rmsnorm(p["cross_q_norm"], q), cm.rmsnorm(p["cross_k_norm"], kt), vt)
        x = x + _head_out(p["cross_out"], o, tp_axis, mesh)
        xn = cm.layernorm(p["norm2"], x, eps=1e-5) * (1 + sc_m) + sh_m
        return x + g_m * cm.ffn(p["ffn"], xn, tp_axis=tp_axis, mesh=mesh)

    for l, (layer_attn, seg_state, seg_l) in enumerate(cm.layer_strategies(attn, attn_state, depth)):
        x = block(cm.layer_of(blocks, l), layer_attn, cm.layer_of(seg_state, seg_l), x)

    fin = params["final_scale_shift"][None] + temb[:, None, :]
    shift, scale = fin[:, 0][:, None], fin[:, 1][:, None]
    x = cm.layernorm({}, x) * (1 + scale) + shift
    return cm.linear(params["proj_out"], x), attn_state
