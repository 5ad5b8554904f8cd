"""Causal 3D video VAE decoder of the CogVideoX family
(counterpart of the CogVideoX half of ``compactfusion_tpu/models/vae3d.py``).

diffusers ``AutoencoderKLCogVideoX``'s decoder, as the JAX package has it:

  * causal 3D convs: the temporal padding repeats the first frame (frame t
    never sees a later one), the spatial padding is zero;
  * ``CogVideoXSpatialNorm3D``: GroupNorm of the features (statistics over
    T, H, W and C/g, in fp32) modulated by 1x1x1 convs of the raw latent
    ``zq`` nearest-resized to the features (the first frame apart when T
    is odd);
  * ``CogVideoXUpsample3D``: nearest 2x in (h, w), and in the first
    ``temporal_compress_levels`` up blocks frames 1..T-1 doubled (T ->
    2T - 1 for odd T), then a per-frame (1, 3, 3) conv;
  * an optional tiled decode: overlapping spatial tiles, all frames a
    tile, blended with linear ramps.

Layout (B, T, H, W, C) and conv weights (kt, kh, kw, I, O), as in the JAX
package.  The convolutions are ``F.conv3d`` on a channels-last view.

At CogVideoX-2b's 49 x 480 x 720 the top level holds 128-256 channels at
every frame, 2-4e9 elements, past what one cuDNN call indexes: each conv
runs over chunks of output frames (:data:`CONV_CHUNK_ELEMS`), each chunk
with its causal halo of input frames, which is the same function; the
norm gathers its fp32 sums chunk by chunk (:data:`NORM_CHUNK_ELEMS`) and
normalizes one chunk at a time, so no fp32 copy of a whole level exists.
``tests/test_torch_cogvideox.py`` holds the chunked forms against the
unchunked ones.

The HunyuanVideo decoder (diffusers ``AutoencoderKLHunyuanVideo``, the
``hv_*`` half): plain GroupNorm resnets (statistics over T, H, W and C/g in
fp32, summed over frame chunks), causal convs with replicate padding in
time and space everywhere (shortcut and upsampler included), time
upsampling in the last ``temporal_compress_levels`` non-final up blocks,
and a single-head mid attention at C = 512 over all T*h*w latent tokens
under a causal frame mask.  The JAX package hands that mask to the dense
math path; at 33 x 544 x 960 its fp32 score matrix alone would take 21.6
GB.  Here the mask is read as what it is, a key prefix per query frame:
frame f's queries attend frames 0..f, one unmasked call each
(:func:`_mid_attn_hv`), which on the GPU is kernel 1's wide body at Sk =
(f + 1) * h * w.  ``tests/test_torch_vae3d_hv.py`` holds it against JAX's
masked path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.ops.attention import sdpa

#: elements (input or output, the larger) of one conv call
CONV_CHUNK_ELEMS = 1 << 30
#: elements of one frame chunk the norm takes to fp32 at a time
NORM_CHUNK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class VAE3DConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    #: 2^levels temporal compression undone by the first ``levels`` up blocks
    temporal_compress_levels: int = 2
    scaling_factor: float = 1.15258426  # CogVideoX
    dtype: Any = torch.bfloat16
    #: decode in overlapping spatial tiles blended with linear ramps
    #: (diffusers ``AutoencoderKLCogVideoX.tiled_decode``; ``--enable_tiling``)
    use_tiling: bool = False
    tile_latent_size: int = 64  # latent px a tile side
    tile_overlap_factor: float = 0.25

    @property
    def temporal_ratio(self) -> int:
        return 2**self.temporal_compress_levels


def cogvideox_vae() -> VAE3DConfig:
    return VAE3DConfig()


def tiny_vae3d() -> VAE3DConfig:
    return VAE3DConfig(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                       temporal_compress_levels=1)


# ---------------------------------------------------------------------------
# init (torch.Generator draws on its device; other draws than the JAX init)
# ---------------------------------------------------------------------------


def _init_conv3(generator, c_in, c_out, k=(3, 3, 3), dtype=torch.bfloat16):
    kt, kh, kw = k
    return {"w": cm.trunc_normal(generator, (kt, kh, kw, c_in, c_out), (kt * kh * kw * c_in) ** -0.5, dtype),
            "b": torch.zeros((c_out,), dtype=dtype, device=generator.device)}


def _init_spatial_norm(generator, c, zq_c, dtype):
    return {"norm": cm.init_layernorm(c, dtype, generator.device),
            "conv_y": _init_conv3(generator, zq_c, c, (1, 1, 1), dtype),
            "conv_b": _init_conv3(generator, zq_c, c, (1, 1, 1), dtype)}


def _init_resnet(generator, c_in, c_out, zq_c, dtype):
    p = {
        "norm1": _init_spatial_norm(generator, c_in, zq_c, dtype),
        "conv1": _init_conv3(generator, c_in, c_out, dtype=dtype),
        "norm2": _init_spatial_norm(generator, c_out, zq_c, dtype),
        "conv2": _init_conv3(generator, c_out, c_out, dtype=dtype),
    }
    if c_in != c_out:
        p["shortcut"] = _init_conv3(generator, c_in, c_out, (1, 1, 1), dtype)
    return p


def init_vae3d_decoder(generator: torch.Generator, cfg: VAE3DConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_vae3d_decoder``."""
    dt = cfg.dtype
    chans = list(reversed(cfg.block_out_channels))
    zq = cfg.latent_channels
    p = {
        "conv_in": _init_conv3(generator, zq, chans[0], dtype=dt),
        "mid_res1": _init_resnet(generator, chans[0], chans[0], zq, dt),
        "mid_res2": _init_resnet(generator, chans[0], chans[0], zq, dt),
        "norm_out": _init_spatial_norm(generator, chans[-1], zq, dt),
        "conv_out": _init_conv3(generator, chans[-1], cfg.out_channels, dtype=dt),
    }
    up = []
    c_prev = chans[0]
    for i, c in enumerate(chans):
        blocks = []
        for _ in range(cfg.layers_per_block + 1):
            blocks.append(_init_resnet(generator, c_prev, c, zq, dt))
            c_prev = c
        blk = {"resnets": blocks}
        if i < len(chans) - 1:
            # the upsampler's conv is a per-frame nn.Conv2d: a (1, 3, 3) kernel
            blk["upsample_conv"] = _init_conv3(generator, c, c, (1, 3, 3), dt)
        up.append(blk)
    p["up"] = up
    return p


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _frame_chunks(frames: int, per_frame: int, cap: int):
    """[(t0, t1), ...] covering ``frames`` with at most ``cap`` elements a
    chunk (at least one frame)."""
    step = max(1, cap // max(per_frame, 1))
    return [(t0, min(t0 + step, frames)) for t0 in range(0, frames, step)]


def _conv_frames(w, bias, xin, kh, kw):
    """Valid in time, 'same' in space: (B, T + kt - 1, H, W, I) -> (B, T, H, W, O)."""
    y = F.conv3d(xin.permute(0, 4, 1, 2, 3), w, bias, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y.permute(0, 2, 3, 4, 1)


def _conv3(p, x: torch.Tensor, causal: bool) -> torch.Tensor:
    """Stride-1 3D conv of (B, T, H, W, C), zero 'same' padding in space.
    In time: ``causal`` puts kt - 1 copies of the first frame in front (the
    JAX ``_causal_conv3``), else zero padding on both sides (``_plain_conv3``).
    Computed over chunks of output frames, each from its window of input
    frames."""
    kt, kh, kw = p["w"].shape[:3]
    w = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)  # (kt, kh, kw, I, O) -> (O, I, kt, kh, kw)
    bias = p["b"].to(x.dtype)
    b, t, hh, ww, c = x.shape
    before = kt - 1 if causal else (kt - 1) // 2
    after = 0 if causal else (kt - 1) // 2

    def window(t0, t1):
        lo, hi = t0 - before, t1 + after
        parts = []
        if lo < 0:
            parts.append(x[:, :1].expand(b, -lo, hh, ww, c) if causal else x.new_zeros((b, -lo, hh, ww, c)))
        parts.append(x[:, max(lo, 0):min(hi, t)])
        if hi > t:
            parts.append(x.new_zeros((b, hi - t, hh, ww, c)))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    chunks = _frame_chunks(t, b * hh * ww * max(c, w.shape[0]), CONV_CHUNK_ELEMS)
    if len(chunks) == 1:
        return _conv_frames(w, bias, window(0, t), kh, kw)
    out = x.new_empty((b, t, hh, ww, w.shape[0]))
    for t0, t1 in chunks:
        out[:, t0:t1] = _conv_frames(w, bias, window(t0, t1), kh, kw)
    return out


def _zq_frames(tz: int, t: int):
    """Source frame of each of the ``t`` feature frames in the latent's
    ``tz``: the first frame apart and the rest upsampled when t is odd."""
    if t == tz:
        return list(range(t))
    if t % 2 == 1 and t > 1:
        rep = (t - 1) // (tz - 1)
        return [0] + [1 + i // rep for i in range((tz - 1) * rep)]
    rep = t // tz
    return [i // rep for i in range(tz * rep)]


def _nearest_resize_zq(zq: torch.Tensor, t: int, hh: int, ww: int, frames=None) -> torch.Tensor:
    """Nearest-resize zq (B, Tz, hz, wz, C) to (B, t, hh, ww, C): integer
    repetition on H and W, CogVideoX's first-frame rule on T.  ``frames``
    (t0, t1): only those feature frames."""
    idx = _zq_frames(zq.shape[1], t)
    t0, t1 = frames or (0, len(idx))
    if idx[t0:t1] != list(range(zq.shape[1])):
        zq = zq.index_select(1, torch.tensor(idx[t0:t1], device=zq.device))
    if hh != zq.shape[2]:
        zq = zq.repeat_interleave(hh // zq.shape[2], dim=2)
    if ww != zq.shape[3]:
        zq = zq.repeat_interleave(ww // zq.shape[3], dim=3)
    return zq


def _spatial_norm(p, x: torch.Tensor, zq: torch.Tensor, groups: int, eps: float = 1e-6,
                  silu: bool = False) -> torch.Tensor:
    """CogVideoXSpatialNorm3D: groupnorm(x) * conv_y(zq') + conv_b(zq'), and
    silu of that with ``silu``.  The statistics (E[x], E[x^2] in fp32 over
    T, H, W and C/g, variance clamped at 0) are summed over frame chunks;
    each chunk is then normalized and modulated on its own (the 1x1x1 convs
    act per frame)."""
    b, t, hh, ww, c = x.shape
    cg = c // groups
    chunks = _frame_chunks(t, b * hh * ww * c, NORM_CHUNK_ELEMS)
    s1 = x.new_zeros((b, 1, 1, 1, groups, 1), dtype=torch.float32)
    s2 = torch.zeros_like(s1)
    for t0, t1 in chunks:
        xc = x[:, t0:t1].float().reshape(b, t1 - t0, hh, ww, groups, cg)
        s1 += xc.sum(dim=(1, 2, 3, 5), keepdim=True)
        s2 += xc.square().sum(dim=(1, 2, 3, 5), keepdim=True)
    n = t * hh * ww * cg
    mu = s1 / n
    inv = torch.rsqrt(torch.clamp(s2 / n - mu * mu, min=0.0) + eps)
    g, beta = p["norm"]["g"].float(), p["norm"]["b"].float()
    out = torch.empty_like(x)
    for t0, t1 in chunks:
        zc = _nearest_resize_zq(zq, t, hh, ww, (t0, t1))
        xc = x[:, t0:t1].float().reshape(b, t1 - t0, hh, ww, groups, cg)
        y = ((xc - mu) * inv).reshape(b, t1 - t0, hh, ww, c) * g + beta
        scale = _conv3(p["conv_y"], zc, causal=False)
        shift = _conv3(p["conv_b"], zc, causal=False)
        y = (y * scale.float() + shift.float()).to(x.dtype)
        out[:, t0:t1] = cm.silu(y) if silu else y
    return out


def _resnet3(p, x, zq, groups):
    h = _conv3(p["conv1"], _spatial_norm(p["norm1"], x, zq, groups, silu=True), causal=True)
    h = _conv3(p["conv2"], _spatial_norm(p["norm2"], h, zq, groups, silu=True), causal=True)
    if "shortcut" in p:
        x = _conv3(p["shortcut"], x, causal=False)
    return h.add_(x)


def _upsample_frames(t: int, temporal: bool):
    """Source frame of each output frame of the upsampler: frames 1..T-1
    doubled (frame 0 kept once) for odd T, every frame for even T."""
    if not temporal or t == 1:
        return list(range(t))
    if t % 2 == 1:
        return [0] + [1 + i // 2 for i in range(2 * (t - 1))]
    return [i // 2 for i in range(2 * t)]


def _upsample3(p, x: torch.Tensor, temporal: bool) -> torch.Tensor:
    """CogVideoXUpsample3D: nearest 2x on (h, w), ``temporal`` doubling of
    the frames (:func:`_upsample_frames`), then the per-frame (1, 3, 3)
    conv; over chunks of output frames, each repeated from its sources."""
    kt, kh, kw = p["w"].shape[:3]
    assert kt == 1, "the upsampler's conv is per frame"
    b, t, h, w, c = x.shape
    idx = torch.tensor(_upsample_frames(t, temporal), device=x.device)
    wt = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)
    bias = p["b"].to(x.dtype)

    def frames(t0, t1):
        xs = x.index_select(1, idx[t0:t1])
        return xs.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    chunks = _frame_chunks(len(idx), b * 4 * h * w * max(c, wt.shape[0]), CONV_CHUNK_ELEMS)
    if len(chunks) == 1:
        return _conv_frames(wt, bias, frames(0, len(idx)), kh, kw)
    out = x.new_empty((b, len(idx), 2 * h, 2 * w, wt.shape[0]))
    for t0, t1 in chunks:
        out[:, t0:t1] = _conv_frames(wt, bias, frames(t0, t1), kh, kw)
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _blend_v3(above, cur, extent):
    """Blend cur's top rows into above's bottom rows ((B, T, H, W, C))."""
    n = min(above.shape[2], cur.shape[2], extent)
    w = (torch.arange(n, dtype=torch.float32, device=cur.device) / n).to(cur.dtype)
    mixed = above[:, :, -n:] * (1.0 - w)[None, None, :, None, None] + cur[:, :, :n] * w[None, None, :, None, None]
    return torch.cat([mixed, cur[:, :, n:]], dim=2)


def _blend_h3(left, cur, extent):
    n = min(left.shape[3], cur.shape[3], extent)
    w = (torch.arange(n, dtype=torch.float32, device=cur.device) / n).to(cur.dtype)
    mixed = (left[:, :, :, -n:] * (1.0 - w)[None, None, None, :, None]
             + cur[:, :, :, :n] * w[None, None, None, :, None])
    return torch.cat([mixed, cur[:, :, :, n:]], dim=3)


def _tiled_decode3d(decode_fn, latents, cfg: VAE3DConfig):
    """Overlapping spatial tiles over (H, W), all frames a tile, blended
    with linear ramps (diffusers ``AutoencoderKLCogVideoX.tiled_decode``'s
    structure; time is not tiled).  Each tile decodes with its own latent
    window, its spatial-norm conditioning included."""
    b, t, h, w, _ = latents.shape
    tl = cfg.tile_latent_size
    if h <= tl and w <= tl:
        return decode_fn(latents)
    upscale = 2 ** (len(cfg.block_out_channels) - 1)
    stride = max(1, int(tl * (1.0 - cfg.tile_overlap_factor)))
    blend = int(tl * upscale * cfg.tile_overlap_factor)
    row_limit = tl * upscale - blend

    rows = [[decode_fn(latents[:, :, i:i + tl, j:j + tl, :]) for j in range(0, w, stride)]
            for i in range(0, h, stride)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v3(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h3(row[j - 1], tile, blend)
            out_row.append(tile[:, :, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=3))
    out = torch.cat(out_rows, dim=2)
    return out[:, :, :h * upscale, :w * upscale]


def vae3d_decode(params, latents: torch.Tensor, cfg: VAE3DConfig) -> torch.Tensor:
    """(B, T_lat, h, w, C_lat) scaled latents -> (B, T, 8h, 8w, 3), with
    T = (T_lat - 1) * temporal_ratio + 1."""
    if cfg.use_tiling:
        dense = dataclasses.replace(cfg, use_tiling=False)
        return _tiled_decode3d(lambda z: vae3d_decode(params, z, dense), latents, cfg)
    g = cfg.norm_num_groups
    zq = (latents / cfg.scaling_factor).to(cfg.dtype)
    x = _conv3(params["conv_in"], zq, causal=True)
    x = _resnet3(params["mid_res1"], x, zq, g)
    x = _resnet3(params["mid_res2"], x, zq, g)
    for i, up in enumerate(params["up"]):
        for r in up["resnets"]:
            x = _resnet3(r, x, zq, g)
        if "upsample_conv" in up:
            x = _upsample3(up["upsample_conv"], x, i < cfg.temporal_compress_levels)
    x = _spatial_norm(params["norm_out"], x, zq, g, silu=True)
    return _conv3(params["conv_out"], x, causal=True)


# ---------------------------------------------------------------------------
# the HunyuanVideo causal 3D VAE decoder (AutoencoderKLHunyuanVideo)
# ---------------------------------------------------------------------------


def hunyuanvideo_vae() -> VAE3DConfig:
    """HunyuanVideo's causal 3D VAE (decoded by :func:`hv_vae3d_decode`)."""
    return VAE3DConfig(block_out_channels=(128, 256, 512, 512), layers_per_block=2, scaling_factor=0.476986)


def tiny_hv_vae3d() -> VAE3DConfig:
    return VAE3DConfig(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                       temporal_compress_levels=1)


def init_hv_vae3d_decoder(generator: torch.Generator, cfg: VAE3DConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_hv_vae3d_decoder`` (plain GroupNorms, the mid attention)."""
    dt, dev = cfg.dtype, generator.device
    chans = list(reversed(cfg.block_out_channels))

    def resnet(c_in, c_out):
        p = {"norm1": cm.init_layernorm(c_in, dt, dev), "conv1": _init_conv3(generator, c_in, c_out, dtype=dt),
             "norm2": cm.init_layernorm(c_out, dt, dev), "conv2": _init_conv3(generator, c_out, c_out, dtype=dt)}
        if c_in != c_out:
            p["shortcut"] = _init_conv3(generator, c_in, c_out, (1, 1, 1), dt)
        return p

    c0 = chans[0]
    p = {
        "conv_in": _init_conv3(generator, cfg.latent_channels, c0, dtype=dt),
        "mid_res1": resnet(c0, c0),
        "mid_attn": {"norm": cm.init_layernorm(c0, dt, dev),
                     **{k: cm.init_linear(generator, c0, c0, dtype=dt) for k in ("q", "k", "v", "out")}},
        "mid_res2": resnet(c0, c0),
        "norm_out": cm.init_layernorm(chans[-1], dt, dev),
        "conv_out": _init_conv3(generator, chans[-1], cfg.out_channels, dtype=dt),
    }
    up, c_prev = [], c0
    for i, c in enumerate(chans):
        blk = {"resnets": [resnet(c_prev if j == 0 else c, c) for j in range(cfg.layers_per_block + 1)]}
        c_prev = c
        if i < len(chans) - 1:
            blk["upsample_conv"] = _init_conv3(generator, c, c, dtype=dt)
        up.append(blk)
    p["up"] = up
    return p


def _edge_pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate padding of (B, T, H, W, C) in H and W."""
    if ph:
        x = torch.cat([x[:, :, :1].expand(-1, -1, ph, -1, -1), x, x[:, :, -1:].expand(-1, -1, ph, -1, -1)], dim=2)
    if pw:
        x = torch.cat([x[:, :, :, :1].expand(-1, -1, -1, pw, -1), x, x[:, :, :, -1:].expand(-1, -1, -1, pw, -1)],
                      dim=3)
    return x


def _causal_conv3_repl(p, x: torch.Tensor, frames=None) -> torch.Tensor:
    """HunyuanVideoCausalConv3d on (B, T, H, W, C): replicate padding
    everywhere, kt - 1 copies of the first frame in front.  ``frames``
    (idx, T_out): the input is the frames ``idx`` of ``x`` (the upsampler's
    frame map), gathered chunk by chunk.  Computed over chunks of output
    frames, each from its causal window."""
    kt, kh, kw = p["w"].shape[:3]
    w = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)
    bias = p["b"].to(x.dtype)
    src = list(range(x.shape[1])) if frames is None else frames
    t = len(src)
    b, _, hh, ww, c = x.shape
    up = 2 if frames is not None else 1

    def window(t0, t1):
        idx = [src[max(j, 0)] for j in range(t0 - (kt - 1), t1)]
        xs = x.index_select(1, torch.tensor(idx, device=x.device)) if idx != list(range(x.shape[1])) else x
        if up > 1:
            xs = xs.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        xs = _edge_pad_hw(xs, (kh - 1) // 2, (kw - 1) // 2)
        return F.conv3d(xs.permute(0, 4, 1, 2, 3), w, bias).permute(0, 2, 3, 4, 1)

    per_frame = b * hh * ww * up * up * max(c, w.shape[0])
    chunks = _frame_chunks(t, per_frame, CONV_CHUNK_ELEMS)
    if len(chunks) == 1:
        return window(0, t)
    out = x.new_empty((b, t, hh * up, ww * up, w.shape[0]))
    for t0, t1 in chunks:
        out[:, t0:t1] = window(t0, t1)
    return out


def _plain_groupnorm3(p, x: torch.Tensor, groups: int, eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """torch GroupNorm over (T, H, W, C/g), time included, and silu of it
    with ``silu``: the fp32 statistics (E[x], E[x^2], variance clamped at
    0) summed over frame chunks, each chunk then normalized on its own."""
    b, t, hh, ww, c = x.shape
    cg = c // groups
    chunks = _frame_chunks(t, b * hh * ww * c, NORM_CHUNK_ELEMS)
    s1 = x.new_zeros((b, 1, 1, 1, groups, 1), dtype=torch.float32)
    s2 = torch.zeros_like(s1)
    for t0, t1 in chunks:
        xc = x[:, t0:t1].float().reshape(b, t1 - t0, hh, ww, groups, cg)
        s1 += xc.sum(dim=(1, 2, 3, 5), keepdim=True)
        s2 += xc.square().sum(dim=(1, 2, 3, 5), keepdim=True)
    n = t * hh * ww * cg
    mu = s1 / n
    inv = torch.rsqrt(torch.clamp(s2 / n - mu * mu, min=0.0) + eps)
    g, beta = p["g"].float(), p["b"].float()
    out = torch.empty_like(x)
    for t0, t1 in chunks:
        xc = x[:, t0:t1].float().reshape(b, t1 - t0, hh, ww, groups, cg)
        y = (((xc - mu) * inv).reshape(b, t1 - t0, hh, ww, c) * g + beta).to(x.dtype)
        out[:, t0:t1] = cm.silu(y) if silu else y
    return out


def _resnet3_hv(p, x, groups):
    h = _causal_conv3_repl(p["conv1"], _plain_groupnorm3(p["norm1"], x, groups, silu=True))
    h = _causal_conv3_repl(p["conv2"], _plain_groupnorm3(p["norm2"], h, groups, silu=True))
    if "shortcut" in p:
        x = _causal_conv3_repl(p["shortcut"], x)
    return h.add_(x)


def _mid_attn_hv(p, x, groups):
    """Single-head attention over the T*h*w tokens under the causal frame
    mask, as one unmasked call per query frame over its key prefix (module
    note): the same function as the masked call, without its score
    matrix."""
    b, t, hh, ww, c = x.shape
    hw = hh * ww
    y = _plain_groupnorm3(p["norm"], x, groups).reshape(b, t * hw, c)
    q, k, v = (cm.linear(p[n], y)[:, :, None, :] for n in ("q", "k", "v"))
    o = torch.empty_like(q)
    for f in range(t):
        rows, keys = slice(f * hw, (f + 1) * hw), slice(0, (f + 1) * hw)
        o[:, rows] = sdpa(q[:, rows], k[:, keys], v[:, keys])
    o = cm.linear(p["out"], o[:, :, 0].to(x.dtype))
    return x + o.reshape(b, t, hh, ww, c)


def _upsample3_hv(p, x: torch.Tensor, temporal: bool) -> torch.Tensor:
    """HunyuanVideoUpsampleCausal3D: nearest 2x in (h, w); with ``temporal``
    the first frame kept once and the others doubled; then the causal
    conv.  The upsampled frames are made chunk by chunk inside the conv."""
    t = x.shape[1]
    idx = [0] + [1 + i // 2 for i in range(2 * (t - 1))] if temporal and t > 1 else list(range(t))
    return _causal_conv3_repl(p, x, frames=idx)


def hv_vae3d_decode(params, latents: torch.Tensor, cfg: VAE3DConfig) -> torch.Tensor:
    """HunyuanVideo decode: (B, T_lat, h, w, C) scaled latents -> (B, T, 8h,
    8w, 3) with T = (T_lat - 1) * temporal_ratio + 1; tiled with
    ``cfg.use_tiling``."""
    if cfg.use_tiling:
        dense = dataclasses.replace(cfg, use_tiling=False)
        return _tiled_decode3d(lambda z: hv_vae3d_decode(params, z, dense), latents, cfg)
    g = cfg.norm_num_groups
    x = _causal_conv3_repl(params["conv_in"], (latents / cfg.scaling_factor).to(cfg.dtype))
    x = _resnet3_hv(params["mid_res1"], x, g)
    x = _mid_attn_hv(params["mid_attn"], x, g)
    x = _resnet3_hv(params["mid_res2"], x, g)
    n_up = len(params["up"])
    for i, up in enumerate(params["up"]):
        for r in up["resnets"]:
            x = _resnet3_hv(r, x, g)
        if "upsample_conv" in up:
            # time upsampling at the last temporal_compress_levels non-final up blocks
            x = _upsample3_hv(up["upsample_conv"], x, i >= n_up - 1 - cfg.temporal_compress_levels)
    x = _plain_groupnorm3(params["norm_out"], x, g, silu=True)
    return _causal_conv3_repl(params["conv_out"], x)
