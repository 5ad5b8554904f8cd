"""Banded VAE decode on separate VAE ranks (counterpart of
``compactfusion_tpu/parallel/vae.py``).

The reference's separate VAE ranks (``parallel_state.py:297-308``,
``distvae``'s ``DecoderAdapter``): the latent image is cut into horizontal
bands, one a VAE rank.  Every 3x3 conv takes one-row halos from the
neighbouring bands (send/recv; zeros at the outer edges, which is exactly
SAME padding), GroupNorm sums its fp32 statistics over the band group, and
the mid-block's global attention runs on the all-gathered feature map
(``sdpa``: kernel 1's wide body at d = 512 on the GPU).  The bands stay
height-aligned across every 2x upsample, so each rank decodes its share of
the pixels.  Same math as ``models/vae.py``'s dense decode; only the
statistics' summation order differs.

The hand-off: rank 0 of the DiT mesh sends the latents to every VAE rank
(:func:`send_to_vae_ranks`), the VAE ranks decode (:func:`decode_on_vae_ranks`)
and the first of them sends the image back to rank 0
(:func:`recv_from_vae_ranks`): the image reaches the caller on rank 0, as
the JAX ``decode_on_vae_mesh`` returns a global array.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.vae import VAEConfig, _conv, _mid_attn
from compactfusion_tpu_torch.ops.attention import sdpa
from compactfusion_tpu_torch.parallel.mesh import AXIS_VAE, Mesh


def _halo(x: torch.Tensor, mesh: Mesh, axis: str):
    """(top, bottom): the last row of the band above and the first row of
    the band below this one, zeros where there is none."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    top, bottom = torch.zeros_like(x[:, :1]), torch.zeros_like(x[:, :1])
    if n == 1:
        return top, bottom
    group, ops, got = mesh.groups[axis], [], {}
    for side, row, peer, nb in (("top", x[:, :1], -1, i > 0), ("bottom", x[:, -1:], +1, i < n - 1)):
        if not nb:
            continue
        send = mesh.wire(row.contiguous().view(torch.uint8))
        got[side] = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, mesh.peer(axis, peer), group=group),
                dist.P2POp(dist.irecv, got[side], mesh.peer(axis, peer), group=group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if "top" in got:
        top = got["top"].to(x.device).view(x.dtype)
    if "bottom" in got:
        bottom = got["bottom"].to(x.device).view(x.dtype)
    return top, bottom


def _conv3_halo(p, x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """3x3 stride-1 conv of a height band (NHWC, HWIO weight), exact by the
    halo rows: the height is padded by the neighbours, the width by zeros."""
    top, bottom = _halo(x, mesh, axis)
    xp = torch.cat([top, x, bottom], dim=1)
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(xp.permute(0, 3, 1, 2), w, p["b"].to(x.dtype), padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def _groupnorm_dist(p, x: torch.Tensor, groups: int, mesh: Mesh, axis: str, eps: float = 1e-6):
    """GroupNorm with its fp32 sums over the band group (one all-reduce of
    sum and sum of squares), clamped variance as in ``models/vae.py``."""
    b, h, w, c = x.shape
    x32 = x.float().reshape(b, h, w, groups, c // groups)
    sums = torch.stack([x32.sum(dim=(1, 2, 4), keepdim=True), x32.square().sum(dim=(1, 2, 4), keepdim=True)])
    s1, s2 = mesh.all_reduce_sum(sums, axis)
    n = float(h * w * (c // groups) * mesh.axis_size(axis))
    mu = s1 / n
    var = torch.clamp(s2 / n - mu * mu, min=0.0)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _resnet_dist(p, x, groups, mesh, axis):
    h = _conv3_halo(p["conv1"], cm.silu(_groupnorm_dist(p["norm1"], x, groups, mesh, axis)), mesh, axis)
    h = _conv3_halo(p["conv2"], cm.silu(_groupnorm_dist(p["norm2"], h, groups, mesh, axis)), mesh, axis)
    if "shortcut" in p:
        x = _conv(p["shortcut"], x)
    return x + h


def _mid_attn_dist(p, x, groups, mesh, axis):
    """The mid-block's global attention on the all-gathered feature map;
    each band keeps its rows of the result."""
    n = mesh.axis_size(axis)
    if n == 1:
        return _mid_attn(p, x, groups)
    xn = _groupnorm_dist(p["norm"], x, groups, mesh, axis)
    b, h, w, c = xn.shape
    full = torch.cat(mesh.all_gather(xn.contiguous(), axis), dim=1).reshape(b, n * h * w, c)
    q, k, v = cm.linear(p["q"], full), cm.linear(p["k"], full), cm.linear(p["v"], full)
    o = sdpa(q[:, :, None, :], k[:, :, None, :], v[:, :, None, :])[:, :, 0]
    o = cm.linear(p["out"], o).reshape(b, n * h, w, c)
    i = mesh.axis_index(axis)
    return x + o[:, i * h:(i + 1) * h]


def _upsample_halo(p, x, mesh, axis):
    x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
    return _conv3_halo(p, x, mesh, axis)


def parallel_vae_decode(params, band: torch.Tensor, cfg: VAEConfig, mesh: Mesh,
                        axis: str = AXIS_VAE) -> torch.Tensor:
    """Decode this rank's height band (B, h / n, w, C_latent) of scaled
    latents -> its band (B, H / n, W, 3) of the image in [-1, 1]; the bands
    in axis order are ``models.vae.vae_decode``'s image."""
    g = cfg.norm_num_groups
    x = (band / cfg.scaling_factor + cfg.shift_factor).to(cfg.dtype)
    x = _conv(params["post_quant_conv"], x)
    x = _conv3_halo(params["conv_in"], x, mesh, axis)
    x = _resnet_dist(params["mid_res1"], x, g, mesh, axis)
    x = _mid_attn_dist(params["mid_attn"], x, g, mesh, axis)
    x = _resnet_dist(params["mid_res2"], x, g, mesh, axis)
    for up in params["up"]:
        for r in up["resnets"]:
            x = _resnet_dist(r, x, g, mesh, axis)
        if "upsample_conv" in up:
            x = _upsample_halo(up["upsample_conv"], x, mesh, axis)
    x = cm.silu(_groupnorm_dist(params["norm_out"], x, g, mesh, axis))
    return _conv3_halo(params["conv_out"], x, mesh, axis)


def send_to_vae_ranks(latents: torch.Tensor, vae_mesh: Mesh) -> None:
    """On rank 0 of the DiT mesh: the latent image (B, h, w, C) to every VAE
    rank, in fp32."""
    buf = vae_mesh.wire(latents.float().contiguous())
    for r in vae_mesh.lines[AXIS_VAE]:
        dist.send(buf, r)


def _buffer(shape, vae_mesh: Mesh, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="cpu" if vae_mesh.backend == "gloo" else device)


def decode_on_vae_ranks(params, latent_shape, cfg: VAEConfig, vae_mesh: Mesh, device) -> None:
    """On a VAE rank: receive the latent image (``latent_shape``, from rank
    0), decode this rank's band, gather the bands, and the first VAE rank
    sends the image (B, H, W, 3) in [-1, 1] to rank 0."""
    n, i = vae_mesh.axis_size(AXIS_VAE), vae_mesh.axis_index(AXIS_VAE)
    if latent_shape[1] % n:
        raise ValueError(f"latent height {latent_shape[1]} does not split into {n} VAE bands")
    buf = _buffer(latent_shape, vae_mesh, device)
    dist.recv(buf, 0)
    hb = latent_shape[1] // n
    band = buf.to(device)[:, i * hb:(i + 1) * hb]
    img = parallel_vae_decode(params, band, cfg, vae_mesh)
    img = torch.cat(vae_mesh.all_gather(img.float().contiguous(), AXIS_VAE), dim=1)
    if i == 0:
        dist.send(vae_mesh.wire(img), 0)


def recv_from_vae_ranks(image_shape, cfg: VAEConfig, vae_mesh: Mesh, device) -> torch.Tensor:
    """On rank 0: the image (``image_shape``) the VAE ranks decoded, in the
    VAE's dtype (it travels in fp32, exactly)."""
    buf = _buffer(image_shape, vae_mesh, device)
    dist.recv(buf, vae_mesh.lines[AXIS_VAE][0])
    return buf.to(device, cfg.dtype)
