"""AutoencoderKL decoder, dense decode (counterpart of ``compactfusion_tpu/models/vae.py``).

Public tensors are NHWC and conv weights HWIO, as in the JAX package.
Inside :func:`_conv` the NHWC activation is viewed as NCHW in PyTorch's
channels-last memory format, so ``F.conv2d`` needs no copy of it.  The
mid-block attention (one head of d=512 over 64x64 = 4096 tokens at 512 px,
128x128 = 16384 with FLUX at 1024 px) meets the flash routing contract and
runs the flash kernel on the GPU.  The decode memory knobs dispatch as in
the JAX package: ``use_slicing`` decodes one batch element at a time
(exact), ``use_tiling`` decodes overlapping spatial tiles blended with
linear ramps (diffusers ``AutoencoderKL.tiled_decode``; each tile's
mid-attention runs over that tile's rows alone).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    dtype: Any = torch.bfloat16
    #: decode memory knobs (reference --enable_slicing / --enable_tiling):
    #: slicing decodes one batch element at a time (exact); tiling decodes
    #: overlapping tiles of ``tile_latent_size`` latent px blended over
    #: ``tile_overlap_factor`` of a tile (approximate at the seams)
    use_slicing: bool = False
    use_tiling: bool = False
    tile_latent_size: int = 64  # diffusers tile_latent_min_size (latent px)
    tile_overlap_factor: float = 0.25

    @property
    def upscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def sd_vae() -> VAEConfig:
    return VAEConfig()


def flux_vae() -> VAEConfig:
    """FLUX's 16-channel AutoencoderKL (scaling and shift of the checkpoint)."""
    return VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159)


def sd3_vae() -> VAEConfig:
    """SD3's 16-channel AutoencoderKL (scaling and shift of the checkpoint)."""
    return VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)


def tiny_vae() -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)


# ---------------------------------------------------------------------------
# init (torch.Generator draws on its device; other draws than the JAX init)
# ---------------------------------------------------------------------------


def _init_conv(generator, c_in, c_out, k=3, dtype=torch.bfloat16):
    return {
        "w": cm.trunc_normal(generator, (k, k, c_in, c_out), (k * k * c_in) ** -0.5, dtype),
        "b": torch.zeros((c_out,), dtype=dtype, device=generator.device),
    }


def _init_groupnorm(c, dtype, device):
    return {
        "g": torch.ones((c,), dtype=dtype, device=device),
        "b": torch.zeros((c,), dtype=dtype, device=device),
    }


def _init_resnet(generator, c_in, c_out, dtype):
    dev = generator.device
    p = {
        "norm1": _init_groupnorm(c_in, dtype, dev),
        "conv1": _init_conv(generator, c_in, c_out, 3, dtype),
        "norm2": _init_groupnorm(c_out, dtype, dev),
        "conv2": _init_conv(generator, c_out, c_out, 3, dtype),
    }
    if c_in != c_out:
        p["shortcut"] = _init_conv(generator, c_in, c_out, 1, dtype)
    return p


def _init_attn(generator, c, dtype):
    return {
        "norm": _init_groupnorm(c, dtype, generator.device),
        "q": cm.init_linear(generator, c, c, dtype=dtype),
        "k": cm.init_linear(generator, c, c, dtype=dtype),
        "v": cm.init_linear(generator, c, c, dtype=dtype),
        "out": cm.init_linear(generator, c, c, dtype=dtype),
    }


def init_vae_decoder(generator: torch.Generator, cfg: VAEConfig):
    dt = cfg.dtype
    chans = cfg.block_out_channels
    c0 = chans[-1]
    p = {
        "post_quant_conv": _init_conv(generator, cfg.latent_channels, cfg.latent_channels, 1, dt),
        "conv_in": _init_conv(generator, cfg.latent_channels, c0, 3, dt),
        "mid_res1": _init_resnet(generator, c0, c0, dt),
        "mid_attn": _init_attn(generator, c0, dt),
        "mid_res2": _init_resnet(generator, c0, c0, dt),
        "norm_out": _init_groupnorm(chans[0], dt, generator.device),
        "conv_out": _init_conv(generator, chans[0], cfg.out_channels, 3, dt),
    }
    up = []
    c_prev = c0
    for c in reversed(chans):
        blocks = []
        for _ in range(cfg.layers_per_block + 1):
            blocks.append(_init_resnet(generator, c_prev, c, dt))
            c_prev = c
        up.append({"resnets": blocks, "upsample_conv": _init_conv(generator, c, c, 3, dt)})
    up[-1].pop("upsample_conv")  # the last up block has no upsample
    p["up"] = up
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _conv(p, x: torch.Tensor) -> torch.Tensor:
    """'SAME' stride-1 conv on NHWC with an HWIO weight."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["b"].to(x.dtype), padding="same")
    return y.permute(0, 2, 3, 1)


def _groupnorm(p, x: torch.Tensor, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics in the E[x^2] - mu^2 form, clamped at 0 (the
    cancellation on near-constant large-mean groups can make it negative)."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).float()
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(xg.square().mean(dim=(1, 2, 4), keepdim=True) - mu * mu, min=0.0)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _resnet(p, x, groups):
    h = _conv(p["conv1"], cm.silu(_groupnorm(p["norm1"], x, groups)))
    h = _conv(p["conv2"], cm.silu(_groupnorm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = _conv(p["shortcut"], x)
    return x + h


def _mid_attn(p, x, groups):
    b, hh, ww, c = x.shape
    y = _groupnorm(p["norm"], x, groups).reshape(b, hh * ww, c)
    q, k, v = cm.linear(p["q"], y), cm.linear(p["k"], y), cm.linear(p["v"], y)
    o = sdpa(q[:, :, None, :], k[:, :, None, :], v[:, :, None, :])[:, :, 0]
    return x + cm.linear(p["out"], o).reshape(b, hh, ww, c)


def _upsample(p, x):
    """Nearest 2x (output pixel i reads input i // 2), then a conv."""
    x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return _conv(p, x.permute(0, 2, 3, 1))


def _vae_decode_dense(params, latents: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    g = cfg.norm_num_groups
    x = (latents / cfg.scaling_factor + cfg.shift_factor).to(cfg.dtype)
    x = _conv(params["post_quant_conv"], x)
    x = _conv(params["conv_in"], x)
    x = _resnet(params["mid_res1"], x, g)
    x = _mid_attn(params["mid_attn"], x, g)
    x = _resnet(params["mid_res2"], x, g)
    for up in params["up"]:
        for r in up["resnets"]:
            x = _resnet(r, x, g)
        if "upsample_conv" in up:
            x = _upsample(up["upsample_conv"], x)
    x = cm.silu(_groupnorm(params["norm_out"], x, g))
    return _conv(params["conv_out"], x)


def _blend_v(above: torch.Tensor, cur: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend ``cur``'s top rows into ``above``'s bottom rows with a linear
    ramp (diffusers ``AutoencoderKL.blend_v``)."""
    n = min(above.shape[1], cur.shape[1], extent)
    w = (torch.arange(n, dtype=torch.float32, device=cur.device) / n).to(cur.dtype)
    mixed = above[:, -n:] * (1.0 - w)[None, :, None, None] + cur[:, :n] * w[None, :, None, None]
    return torch.cat([mixed, cur[:, n:]], dim=1)


def _blend_h(left: torch.Tensor, cur: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend ``cur``'s left columns into ``left``'s right columns
    (diffusers ``AutoencoderKL.blend_h``)."""
    n = min(left.shape[2], cur.shape[2], extent)
    w = (torch.arange(n, dtype=torch.float32, device=cur.device) / n).to(cur.dtype)
    mixed = left[:, :, -n:] * (1.0 - w)[None, None, :, None] + cur[:, :, :n] * w[None, None, :, None]
    return torch.cat([mixed, cur[:, :, n:]], dim=2)


def vae_decode_tiled(params, latents: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """Decode overlapping tiles of ``cfg.tile_latent_size`` latent px taken
    at a stride of ``tile * (1 - overlap)``; each decoded tile is blended
    into its top and left neighbours over ``tile_sample * overlap`` output
    px and cropped to the stride (diffusers ``tiled_decode``).  The blend
    sources are the neighbours as decoded, never as blended.  Peak
    activation memory is that of one tile."""
    b, h, w, _ = latents.shape
    tl = cfg.tile_latent_size
    if h <= tl and w <= tl:
        return _vae_decode_dense(params, latents, cfg)
    f = cfg.upscale_factor
    stride = max(1, int(tl * (1.0 - cfg.tile_overlap_factor)))
    blend = int(tl * f * cfg.tile_overlap_factor)
    row_limit = tl * f - blend
    rows = [[_vae_decode_dense(params, latents[:, i:i + tl, j:j + tl, :], cfg) for j in range(0, w, stride)]
            for i in range(0, h, stride)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            out_row.append(tile[:, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=2))
    return torch.cat(out_rows, dim=1)[:, :h * f, :w * f]


def vae_decode(params, latents: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """(B, h, w, latent_channels) scaled latents -> (B, H, W, 3) in [-1, 1];
    ``use_slicing`` decodes the batch one element at a time, ``use_tiling``
    in tiles (:func:`vae_decode_tiled`)."""
    inner = vae_decode_tiled if cfg.use_tiling else _vae_decode_dense
    if cfg.use_slicing and latents.shape[0] > 1:
        return torch.cat([inner(params, latents[i:i + 1], cfg) for i in range(latents.shape[0])], dim=0)
    return inner(params, latents, cfg)
