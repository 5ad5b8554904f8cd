"""Latte video DiT: alternating spatial and temporal transformer blocks
(counterpart of ``compactfusion_tpu/models/latte.py``).

Pairs of blocks: a spatial block (PixArt's AdaLN-single self-attention
within each frame plus the cross-attention to the text) and a temporal
block (self-attention across the frames at each spatial location, no
cross-attention), with a temporal position table added before the first
temporal block.  Block parameters are stacked on a leading layer axis per
kind, as the JAX ``init_latte`` builds them.

Sequence parallelism is frame-aligned, as in the JAX package: each rank
holds ``frames / sp`` whole frames, so the spatial attention needs no
communication, and a temporal block swaps frame sharding for spatial
sharding with one all-to-all over the (ring, ulysses) ranks and back with
another (:func:`sp_all_to_all`; ``Mesh.all_to_all`` moves the blocks as
bytes, the route the port's Ulysses takes, since gloo has no bf16
collectives).  The temporal attention (16 keys) folds the batch into the
heads, so that it is one batched product rather than one per row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.pixart import _cross_attn
from compactfusion_tpu_torch.ops.attention import sdpa
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, AXIS_ULYSSES, Mesh


@dataclasses.dataclass(frozen=True)
class LatteConfig:
    dim: int = 1152
    #: spatial + temporal block pairs: Latte-1 (diffusers num_layers=28)
    #: ships 28 spatial and 28 temporal blocks
    num_pairs: int = 28
    heads: int = 16
    patch: int = 2
    in_channels: int = 4
    out_channels: int = 8
    text_dim: int = 4096
    ffn_mult: int = 4
    max_frames: int = 64
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim // self.heads


def latte_1() -> LatteConfig:
    return LatteConfig()


def latte_tiny() -> LatteConfig:
    return LatteConfig(dim=64, num_pairs=2, heads=4, text_dim=32, max_frames=8)


def init_latte(generator: torch.Generator, cfg: LatteConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_latte`` (other draws)."""
    d, dt, dev, L = cfg.dim, cfg.dtype, generator.device, (cfg.num_pairs,)

    def table():
        return torch.zeros(L + (6, d), dtype=dt, device=dev)

    spatial = {
        "scale_shift_table": table(),
        "attn_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "cross_q": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "cross_kv": cm.init_linear(generator, d, 2 * d, dtype=dt, stack=L),
        "cross_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "ffn": cm.init_ffn(generator, d, cfg.ffn_mult * d, dtype=dt, stack=L),
    }
    temporal = {
        "scale_shift_table": table(),
        "attn_qkv": cm.init_linear(generator, d, 3 * d, dtype=dt, stack=L),
        "attn_out": cm.init_linear(generator, d, d, dtype=dt, stack=L),
        "ffn": cm.init_ffn(generator, d, cfg.ffn_mult * d, dtype=dt, stack=L),
    }
    return {
        "patch_embed": cm.init_linear(generator, cfg.patch**2 * cfg.in_channels, d, dtype=dt),
        "t_embed": cm.init_timestep_embedder(generator, 256, d, dtype=dt),
        "adaln_single": cm.init_linear(generator, d, 6 * d, dtype=dt),
        "caption_fc1": cm.init_linear(generator, cfg.text_dim, d, dtype=dt),
        "caption_fc2": cm.init_linear(generator, d, d, dtype=dt),
        "spatial_blocks": spatial,
        "temporal_blocks": temporal,
        "final_scale_shift": torch.zeros((2, d), dtype=dt, device=dev),
        "proj_out": cm.init_linear(generator, d, cfg.patch**2 * cfg.out_channels, dtype=dt),
    }


def sp_all_to_all(x: torch.Tensor, mesh: Mesh, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all`` over the mesh axes (ring, ulysses)
    together (rank ``ring * U + ulysses``): block j of ``x`` along
    ``split_dim`` goes to sequence-parallel rank j, the received blocks are
    concatenated along ``concat_dim`` in source order.  With both axes > 1
    it is one all-to-all over the ring, then one over Ulysses."""
    r, u = mesh.axis_size(AXIS_RING), mesh.axis_size(AXIS_ULYSSES)
    if u == 1:
        return mesh.all_to_all(x, AXIS_RING, split_dim, concat_dim)
    if r == 1:
        return mesh.all_to_all(x, AXIS_ULYSSES, split_dim, concat_dim)
    blocks = torch.stack(x.chunk(r * u, dim=split_dim))
    blocks = blocks.reshape((r, u) + tuple(blocks.shape[1:]))
    blocks = mesh.all_to_all(blocks, AXIS_RING, 0, 0)  # [r_src, u] from (r_src, my u)
    blocks = mesh.all_to_all(blocks, AXIS_ULYSSES, 1, 1)  # [r_src, u_src] addressed to me
    return torch.cat(blocks.reshape((r * u,) + tuple(blocks.shape[2:])).unbind(0), dim=concat_dim)


def _temporal_sdpa(q, k, v):
    """(N, F, H, D) attention over the F frames of each of N rows, the rows
    folded into the heads: one (1, F, N*H, D) call."""
    n, f, h, d = q.shape

    def fold(t):
        return t.permute(1, 0, 2, 3).reshape(1, f, n * h, d)

    return sdpa(fold(q), fold(k), fold(v)).reshape(f, n, h, d).permute(1, 0, 2, 3)


def latte_forward(
    params,
    x: torch.Tensor,
    t: torch.Tensor,
    text: torch.Tensor,
    cfg: LatteConfig,
    *,
    frames_local: int,
    frames_total: int,
    spatial_tokens: int,
    pos_embed: torch.Tensor,
    temporal_pos_embed: torch.Tensor,
    mesh: Optional[Mesh] = None,
    text_mask: Optional[torch.Tensor] = None,
    tp_axis: Optional[str] = None,
):
    """Latte denoiser on this rank's frames.

    x (B, frames_local * spatial_tokens, p*p*C) frame-major raster order;
    pos_embed (spatial_tokens, dim), the same table every frame;
    temporal_pos_embed (frames_total, dim); ``mesh``: the frames are
    sharded over its (ring, ulysses) ranks when ``frames_local <
    frames_total``.  ``tp_axis``: every block's ffn holds this rank's share
    (``parallel/tp.py::local_params``) and sums it over that axis of
    ``mesh``; the attention stays whole on every rank.  Returns (out, ()):
    Latte has no attention state."""
    b = x.shape[0]
    d, h = cfg.dim, cfg.heads
    f_l, s_sp = frames_local, spatial_tokens
    sp_world = frames_total // frames_local
    if sp_world > 1 and mesh is None:
        raise ValueError(f"{sp_world} sequence-parallel ranks need this rank's mesh")

    x = cm.linear(params["patch_embed"], x)
    x = x + pos_embed.to(x.device, cfg.dtype).repeat(f_l, 1)[None]
    temb = cm.timestep_embedder(params["t_embed"], t, 256)
    mod6 = cm.linear(params["adaln_single"], cm.silu(temb)).reshape(-1, 6, d)
    text = cm.linear(params["caption_fc2"], cm.gelu(cm.linear(params["caption_fc1"], text)))
    # padding masks are contiguous prefixes: flash-compatible lengths
    kv_lens = text_mask.sum(dim=-1).to(torch.int32) if text_mask is not None else None

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], h, d // h)

    def unheads(y):
        return y.reshape(y.shape[0], y.shape[1], d)

    def modulate(table, y, i_shift, i_scale):
        return cm.layernorm({}, y) * (1 + table[:, i_scale][:, None]) + table[:, i_shift][:, None]

    def spatial_block(p, x):
        # (B, f_l*s_sp, D) -> (B*f_l, s_sp, D): the frames are independent rows
        table_r = (p["scale_shift_table"][None] + mod6).repeat_interleave(f_l, dim=0)
        xs = x.reshape(b * f_l, s_sp, d)
        q, k, v = (heads(y) for y in cm.linear(p["attn_qkv"], modulate(table_r, xs, 0, 1)).chunk(3, dim=-1))
        xs = xs + table_r[:, 2][:, None] * cm.linear(p["attn_out"], unheads(sdpa(q, k, v)))
        q = heads(cm.linear(p["cross_q"], xs))
        # the text projected once, then repeated per frame
        kt, vt = (y.repeat_interleave(f_l, dim=0) for y in cm.linear(p["cross_kv"], text).chunk(2, dim=-1))
        lens_r = kv_lens.repeat_interleave(f_l, dim=0) if kv_lens is not None else None
        o = _cross_attn(q, heads(kt), heads(vt), None, kv_lens=lens_r)
        xs = xs + cm.linear(p["cross_out"], unheads(o))
        xs = xs + table_r[:, 5][:, None] * cm.ffn(p["ffn"], modulate(table_r, xs, 3, 4), tp_axis=tp_axis, mesh=mesh)
        return xs.reshape(b, f_l * s_sp, d)

    def to_temporal(x):
        """frame-sharded (B, f_l*s_sp, D) -> space-sharded (B*s_sp/W, F, D)."""
        xt = x.reshape(b, f_l, s_sp, d)
        if sp_world > 1:
            xt = sp_all_to_all(xt, mesh, split_dim=2, concat_dim=1)  # (B, F, s_sp/W, D)
        return xt.permute(0, 2, 1, 3).reshape(-1, frames_total, d)

    def from_temporal(xt):
        xt = xt.reshape(b, s_sp // sp_world, frames_total, d).permute(0, 2, 1, 3)
        if sp_world > 1:
            xt = sp_all_to_all(xt, mesh, split_dim=1, concat_dim=2)  # (B, f_l, s_sp, D)
        return xt.reshape(b, f_l * s_sp, d)

    def temporal_block(p, x, first: bool):
        xt = to_temporal(x)  # (B*s_loc, F, D)
        if first:
            xt = xt + temporal_pos_embed.to(xt.device, cfg.dtype)[None]
        table_r = (p["scale_shift_table"][None] + mod6).repeat_interleave(xt.shape[0] // b, dim=0)
        q, k, v = (heads(y) for y in cm.linear(p["attn_qkv"], modulate(table_r, xt, 0, 1)).chunk(3, dim=-1))
        xt = xt + table_r[:, 2][:, None] * cm.linear(p["attn_out"], unheads(_temporal_sdpa(q, k, v)))
        xt = xt + table_r[:, 5][:, None] * cm.ffn(p["ffn"], modulate(table_r, xt, 3, 4), tp_axis=tp_axis, mesh=mesh)
        return from_temporal(xt)

    for i in range(cfg.num_pairs):
        x = spatial_block(cm.layer_of(params["spatial_blocks"], i), x)
        x = temporal_block(cm.layer_of(params["temporal_blocks"], i), x, first=i == 0)

    fin = params["final_scale_shift"][None] + temb[:, None, :]
    shift, scale = fin[:, 0][:, None], fin[:, 1][:, None]
    x = cm.layernorm({}, x) * (1 + scale) + shift
    return cm.linear(params["proj_out"], x), ()
