"""Functional building blocks shared by the DiT backbones
(counterpart of ``compactfusion_tpu/models/common.py``).

Parameters are plain dicts of tensors in the JAX layouts: a linear weight is
``(d_in, d_out)`` and ``y = x @ w + b``.  Norms keep fp32 statistics and
return the input dtype, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

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


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with JAX dtype promotion (an fp32 input against bf16
    weights computes in fp32, as ``jnp.matmul`` does)."""
    w = p["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if "b" in p:
        y = y + p["b"]
    return y


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if "g" in p:
        y = y * p["g"].float() + p["b"].float()
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
    emb = sinusoidal_embedding(t, dim).to(p["fc1"]["w"].dtype)
    return linear(p["fc2"], silu(linear(p["fc1"], emb)))


def _sincos_embed_1d(x: torch.Tensor, d: int) -> torch.Tensor:
    omega = torch.arange(d // 2, dtype=torch.float32) / (d / 2.0)
    omega = 1.0 / (10000.0**omega)
    out = x[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_pos_embed_2d(dim: int, h_patches: int, w_patches: int,
                        base_size: Optional[int] = None,
                        interpolation_scale: float = 1.0) -> torch.Tensor:
    """2D sin-cos positional table (H*W, dim), raster order, fp32, on the CPU.

    The first half of the channels embeds the column coordinate (diffusers
    ``get_2d_sincos_pos_embed``)."""
    rows = torch.arange(h_patches).repeat_interleave(w_patches).float()
    cols = torch.arange(w_patches).repeat(h_patches).float()
    if base_size is not None:
        rows = rows / (h_patches / base_size) / interpolation_scale
        cols = cols / (w_patches / base_size) / interpolation_scale
    half = dim // 2
    return torch.cat([_sincos_embed_1d(cols, half), _sincos_embed_1d(rows, half)], dim=-1)


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


def ffn(p, x: torch.Tensor, act=gelu, tp_axis: Optional[str] = None) -> torch.Tensor:
    """GELU MLP.  Tensor parallelism (``tp_axis``) is not ported yet."""
    if tp_axis is not None:
        from compactfusion_tpu_torch import ROADMAP_HINT

        raise NotImplementedError(f"tensor-parallel ffn: {ROADMAP_HINT}")
    return linear(p["fc2"], act(linear(p["fc1"], x)))
