"""HunyuanVideo-T2V in plain PyTorch: the token refiner, FLUX's blocks with
3-axis rotary embedding (theta 256) over (frame, row, col), and the
flow-match Euler loop on latent tokens.

One departure from the published model, which the configuration states
(``attend_padded_text``): the published model (diffusers
``HunyuanVideoTransformer3DModel``, the original's ``cu_seqlens``) leaves
the prompt's padded text tokens out of the joint attention of the double
and single blocks, where this system (the port and the JAX package alike)
attends all of the text tokens.  ``mask_joint=True`` computes the published
model, to measure the departure."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cfbench.reference import mmdit


def video_positions(frames: int, hp: int, wp: int, device) -> torch.Tensor:
    """(frames * hp * wp, 3) ids (t, row, col), frame-major raster order."""
    t = torch.arange(frames, device=device).repeat_interleave(hp * wp)
    rows = torch.arange(hp, device=device).repeat_interleave(wp).repeat(frames)
    cols = torch.arange(wp, device=device).repeat(frames * hp)
    return torch.stack([t, rows, cols], dim=-1)


def token_refiner(p, text, mask, t, heads, prec):
    """Raw LLaMA states (B, S, 4096) -> refined (B, S, dim)
    (diffusers ``HunyuanVideoTokenRefiner``): the conditioning is the
    timestep plus the projected masked mean of the text; each block gates
    self-attention (mask: both tokens valid, or the key is token 0) and a
    linear-SiLU MLP by an AdaNorm of it."""
    text = text.float()
    m = mask.float()
    pooled = (text * m[..., None]).sum(1) / m.sum(1, keepdim=True)
    temb = mmdit.embed(p["t_embed"], mmdit.timestep_embedding(t), prec) + mmdit.embed(p["c_embed"], pooled, prec)
    x = mmdit.linear(p["proj_in"], text, prec)
    b, s, d = x.shape
    allowed = mask[:, None, :, None] & mask[:, None, None, :]
    allowed[..., 0] = True
    blocks = p["blocks"]
    for i in range(blocks["attn_qkv"]["w"].shape[0]):
        bp = mmdit.layer(blocks, i)
        g_attn, g_ff = mmdit.linear(bp["ada"], F.silu(temb), prec)[:, None].chunk(2, dim=-1)
        xn = mmdit.layernorm(x, bp["norm1"]["g"], bp["norm1"]["b"])
        q, k, v = (y.reshape(b, s, heads, d // heads).transpose(1, 2)
                   for y in mmdit.linear(bp["attn_qkv"], xn, prec).chunk(3, dim=-1))
        scores = torch.matmul(prec.operand(q), prec.operand(k).transpose(-1, -2)) * (d // heads) ** -0.5
        attn = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        o = torch.matmul(prec.operand(attn), prec.operand(v)).transpose(1, 2).reshape(b, s, d)
        x = x + g_attn * mmdit.linear(bp["attn_out"], o, prec)
        xn = mmdit.layernorm(x, bp["norm2"]["g"], bp["norm2"]["b"])
        x = x + g_ff * mmdit.mlp(bp["ffn"], xn, prec, act=F.silu)
    return x


def velocity(params, x, text, mask, pooled, t, guidance, m, rope_img, prec, mask_joint):
    """The transformer on packed latent tokens (B, S, 64); ``mask_joint``:
    the blocks' joint attention leaves the padded text tokens out."""
    img = mmdit.linear(params["x_embedder"], x, prec)
    txt = token_refiner(params["refiner"], text, mask, t, m["heads"], prec)
    temb = mmdit.conditioning(params, pooled, t, guidance, prec)
    keys = None
    if mask_joint:
        keys = torch.cat([mask, torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)], dim=1)
    return mmdit.blocks_and_head(params, img, txt, temb, rope_img, m["heads"], prec, key_mask=keys)


def generate(params, inputs, m, traffic, prec, mask_joint=None):
    """One request: {"latents"} after the request's steps; ``mask_joint``
    None follows the configuration."""
    if mask_joint is None:
        mask_joint = not m["attend_padded_text"]
    f = (traffic["frames"] - 1) // 4 + 1
    hp, wp = traffic["height"] // 16, traffic["width"] // 16
    noise = inputs["noise"]
    dev, b = noise.device, noise.shape[0]
    rope_img = mmdit.rope_tables(video_positions(f, hp, wp, dev), m["axes_dim"], m["rope_theta"])
    g = torch.full((b,), traffic["guidance"] * 1000.0, device=dev)

    def v(x, t):
        return velocity(params, x, inputs["txt"], inputs["mask"], inputs["pooled"], torch.full((b,), t, device=dev),
                        g, m, rope_img, prec, mask_joint)

    return {"latents": mmdit.euler(v, noise, mmdit.static_shift_sigmas(traffic["steps"], traffic["shift"]))}
