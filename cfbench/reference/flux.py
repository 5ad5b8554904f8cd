"""FLUX.1-dev text-to-image in plain PyTorch: the denoiser, the flow-match
Euler loop and FLUX's VAE decode of the final latents."""

from __future__ import annotations

import torch

from cfbench.reference import mmdit, vae2d


def image_positions(hp: int, wp: int, device) -> torch.Tensor:
    """(hp * wp, 3) ids (0, row, col) of the packed latent grid, raster order."""
    rows = torch.arange(hp, device=device).repeat_interleave(wp)
    cols = torch.arange(wp, device=device).repeat(hp)
    return torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)


def velocity(params, x, txt, pooled, t, guidance, m, rope_img, prec):
    """The transformer: packed latent tokens (B, S, 64), T5 states (B, 512,
    4096), CLIP pooled (B, 768), t and guidance (B,) in train units."""
    img = mmdit.linear(params["x_embedder"], x, prec)
    txt = mmdit.linear(params["context_embedder"], txt.float(), prec)
    temb = mmdit.conditioning(params, pooled, t, guidance, prec)
    return mmdit.blocks_and_head(params, img, txt, temb, rope_img, m["heads"], prec)


def generate(params, vae_params, inputs, m, traffic, prec):
    """One request: {"latents", "image"} from its noise and text."""
    hp, wp = traffic["height"] // 16, traffic["width"] // 16
    noise, txt, pooled = inputs["noise"], inputs["txt"], inputs["pooled"]
    dev, b = noise.device, noise.shape[0]
    rope_img = mmdit.rope_tables(image_positions(hp, wp, dev), m["axes_dim"], 10000.0)
    g = torch.full((b,), traffic["guidance"] * 1000.0, device=dev)

    def v(x, t):
        return velocity(params, x, txt, pooled, torch.full((b,), t, device=dev), g, m, rope_img, prec)

    lat = mmdit.euler(v, noise, mmdit.flux_sigmas(traffic["steps"], hp * wp))
    return {"latents": lat, "image": vae2d.decode(vae_params, unpack(lat, hp, wp), m["vae"], prec)}


def unpack(tokens, hp, wp):
    """(B, hp * wp, 4C) tokens packed (2, 2, C) -> (B, 2hp, 2wp, C)."""
    b, _, c4 = tokens.shape
    x = tokens.reshape(b, hp, wp, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * hp, 2 * wp, c4 // 4)
