"""FLUX's AutoencoderKL decoder in plain PyTorch (diffusers ``Decoder``):
conv_in, a mid block of two ResNets around one single-head attention over
the pixels, four up blocks of ResNets with nearest 2x upsampling, GroupNorm,
SiLU, conv_out; no ``post_quant_conv`` (FLUX's ``use_post_quant_conv`` is
false).  Weights are HWIO, activations NCHW inside; the image comes back
(B, H, W, 3) in [0, 1]."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cfbench.reference import mmdit


def _conv(p, x, prec):
    w = prec.operand(p["w"]).permute(3, 2, 0, 1)
    return F.conv2d(prec.operand(x), w, p["b"].float(), padding=w.shape[-1] // 2)


def _norm(p, x, groups):
    return F.group_norm(x, groups, p["g"].float(), p["b"].float(), eps=1e-6)


def _resnet(p, x, groups, prec):
    h = _conv(p["conv1"], F.silu(_norm(p["norm1"], x, groups)), prec)
    h = _conv(p["conv2"], F.silu(_norm(p["norm2"], h, groups)), prec)
    return (_conv(p["shortcut"], x, prec) if "shortcut" in p else x) + h


def _attn(p, x, groups, prec):
    b, c, h, w = x.shape
    y = _norm(p["norm"], x, groups).reshape(b, c, h * w).transpose(1, 2)
    q, k, v = (mmdit.linear(p[n], y, prec)[:, :, None, :] for n in ("q", "k", "v"))
    o = mmdit.attention(q, k, v, prec)[:, :, 0]
    return x + mmdit.linear(p["out"], o, prec).transpose(1, 2).reshape(b, c, h, w)


def decode(p, latents, v, prec):
    """(B, h, w, C) latents -> (B, 8h, 8w, 3) image in [0, 1]."""
    g = v["norm_num_groups"]
    x = (latents.float() / v["scaling_factor"] + v["shift_factor"]).permute(0, 3, 1, 2)
    if v["use_post_quant_conv"]:
        x = _conv(p["post_quant_conv"], x, prec)
    x = _conv(p["conv_in"], x, prec)
    x = _resnet(p["mid_res1"], x, g, prec)
    x = _attn(p["mid_attn"], x, g, prec)
    x = _resnet(p["mid_res2"], x, g, prec)
    for up in p["up"]:
        for r in up["resnets"]:
            x = _resnet(r, x, g, prec)
        if "upsample_conv" in up:
            x = _conv(up["upsample_conv"], F.interpolate(x, scale_factor=2, mode="nearest"), prec)
    x = _conv(p["conv_out"], F.silu(_norm(p["norm_out"], x, g)), prec)
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
