"""The MMDiT blocks FLUX.1 and HunyuanVideo share, in plain PyTorch.

Published equations (diffusers ``FluxTransformerBlock``,
``FluxSingleTransformerBlock``, ``HunyuanVideoTransformerBlock``,
``HunyuanVideoSingleTransformerBlock``): AdaLN-Zero modulation from the
conditioning vector, RMS-normed q and k per head, rotary embedding on the
image (video) tokens only, joint attention over [text, image], GELU (tanh)
MLPs; the single blocks on the fused stream with the attention and MLP
halves summed through one output projection.  Everything is float32; each
operand of a product goes through ``prec.operand``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: bytes of float32 scores one attention block may hold
SCORE_BYTES = 2**31


def linear(p, x, prec):
    y = prec.operand(x) @ prec.operand(p["w"])
    return y + p["b"].float() if "b" in p else y


def layer(tree, i):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def depth(stack) -> int:
    return next(iter(stack.values()))["w"].shape[0]


def layernorm(x, g=None, b=None, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], None if g is None else g.float(), None if b is None else b.float(), eps)


def rmsnorm(x, g, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g.float()


def modulate(x, shift, scale):
    return layernorm(x) * (1 + scale) + shift


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def mlp(p, x, prec, act=gelu_tanh):
    return linear(p["fc2"], act(linear(p["fc1"], x, prec)), prec)


def timestep_embedding(t, dim=256):
    """Sinusoidal embedding of ``t`` (B,): [cos, sin] of t * 10000^(-i/half)
    (diffusers ``Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def embed(p, x, prec):
    """linear -> SiLU -> linear (``TimestepEmbedding``, ``PixArtAlphaTextProjection``)."""
    return linear(p["fc2"], F.silu(linear(p["fc1"], x, prec)), prec)


def rope_tables(positions, axes_dim, theta):
    """(S, n_axes) integer positions -> cos, sin (S, head_dim / 2): each axis
    i takes axes_dim[i] / 2 frequencies theta^(-2j / axes_dim[i])."""
    cos, sin = [], []
    for i, d in enumerate(axes_dim):
        inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=positions.device) / d)
        ang = positions[:, i].double()[:, None] * inv[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def rope(x, cos, sin):
    """Rotate (B, S, H, D) by per-token tables, pairs (j, j + D/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, prec, key_mask=None):
    """softmax(q k^T / sqrt(D)) v over (B, S, H, D) float32 tensors, in blocks
    of heads and query rows whose scores fit :data:`SCORE_BYTES`.
    ``key_mask`` (B, Sk) bool: the keys each batch row attends (the others
    are left out)."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q, dtype=torch.float32)
    q, k, v = (prec.operand(t) for t in (q, k, v))
    for i in range(b):
        qi, ki, vi = (t[i].transpose(0, 1).contiguous() for t in (q, k, v))  # (H, S, D)
        if key_mask is not None:
            ki, vi = ki[:, key_mask[i]], vi[:, key_mask[i]]
        sk = ki.shape[1]
        per_head = max(1, SCORE_BYTES // (4 * sk * sq))
        rows = sq if per_head > 1 else max(1, SCORE_BYTES // (4 * sk))
        for h0 in range(0, h, per_head):
            hs = slice(h0, min(h, h0 + per_head))
            for r0 in range(0, sq, rows):
                rs = slice(r0, min(sq, r0 + rows))
                p = torch.softmax(torch.matmul(qi[hs, rs], ki[hs].transpose(1, 2)) * d**-0.5, dim=-1)
                out[i, rs, hs] = torch.matmul(prec.operand(p), vi[hs]).transpose(0, 1)
    return out


def _heads(x, h):
    return x.reshape(*x.shape[:2], h, x.shape[-1] // h)


def _unheads(x):
    return x.reshape(*x.shape[:2], -1)


def _qkv(p_qkv, p_qn, p_kn, x, h, prec):
    q, k, v = (_heads(t, h) for t in linear(p_qkv, x, prec).chunk(3, dim=-1))
    return rmsnorm(q, p_qn["g"]), rmsnorm(k, p_kn["g"]), v


def double_block(p, img, txt, temb, rope_img, heads, prec, key_mask=None):
    """One dual-stream block: (img, txt) -> (img, txt)."""
    act = F.silu(temb)
    i_sh_a, i_sc_a, i_g_a, i_sh_m, i_sc_m, i_g_m = linear(p["img_mod"], act, prec)[:, None].chunk(6, dim=-1)
    t_sh_a, t_sc_a, t_g_a, t_sh_m, t_sc_m, t_g_m = linear(p["txt_mod"], act, prec)[:, None].chunk(6, dim=-1)
    iq, ik, iv = _qkv(p["img_qkv"], p["img_q_norm"], p["img_k_norm"], modulate(img, i_sh_a, i_sc_a), heads, prec)
    tq, tk, tv = _qkv(p["txt_qkv"], p["txt_q_norm"], p["txt_k_norm"], modulate(txt, t_sh_a, t_sc_a), heads, prec)
    iq, ik = rope(iq, *rope_img), rope(ik, *rope_img)
    o = attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1), torch.cat([tv, iv], 1), prec, key_mask)
    s_txt = txt.shape[1]
    img = img + i_g_a * linear(p["img_out"], _unheads(o[:, s_txt:]), prec)
    txt = txt + t_g_a * linear(p["txt_out"], _unheads(o[:, :s_txt]), prec)
    img = img + i_g_m * mlp(p["img_ffn"], modulate(img, i_sh_m, i_sc_m), prec)
    txt = txt + t_g_m * mlp(p["txt_ffn"], modulate(txt, t_sh_m, t_sc_m), prec)
    return img, txt


def single_block(p, x, s_txt, temb, rope_img, heads, prec, key_mask=None):
    """One single-stream block on the fused (txt | img) stream."""
    sh, sc, g = linear(p["mod"], F.silu(temb), prec)[:, None].chunk(3, dim=-1)
    xn = modulate(x, sh, sc)
    q, k, v = _qkv(p["qkv"], p["q_norm"], p["k_norm"], xn, heads, prec)
    q = torch.cat([q[:, :s_txt], rope(q[:, s_txt:], *rope_img)], 1)
    k = torch.cat([k[:, :s_txt], rope(k[:, s_txt:], *rope_img)], 1)
    o = attention(q, k, v, prec, key_mask)
    return x + g * (linear(p["out_attn"], _unheads(o), prec) + mlp(p["mlp"], xn, prec))


def blocks_and_head(params, img, txt, temb, rope_img, heads, prec, key_mask=None):
    """The double blocks, the single blocks and the AdaLN-Continuous head on
    embedded (B, S_img, dim) image and (B, S_txt, dim) text streams ->
    (B, S_img, out_channels)."""
    for i in range(depth(params["double_blocks"])):
        img, txt = double_block(layer(params["double_blocks"], i), img, txt, temb, rope_img, heads, prec, key_mask)
    s_txt = txt.shape[1]
    x = torch.cat([txt, img], 1)
    del img, txt
    for i in range(depth(params["single_blocks"])):
        x = single_block(layer(params["single_blocks"], i), x, s_txt, temb, rope_img, heads, prec, key_mask)
    scale, shift = linear(params["norm_out_mod"], F.silu(temb), prec)[:, None].chunk(2, dim=-1)
    return linear(params["proj_out"], modulate(x[:, s_txt:], shift, scale), prec)


def conditioning(params, pooled, t, guidance, prec):
    """timestep + pooled text (+ guidance) embedding (B, dim)."""
    temb = embed(params["t_embed"], timestep_embedding(t), prec) + embed(params["pooled_embed"], pooled.float(), prec)
    if "guidance_embed" in params:
        temb = temb + embed(params["guidance_embed"], timestep_embedding(guidance), prec)
    return temb


def euler(velocity, noise, sigmas):
    """Flow-match Euler: x <- x + (sigma_{i+1} - sigma_i) v(x, sigma_i * 1000)."""
    x = noise.float()
    for i in range(len(sigmas) - 1):
        x = x + (sigmas[i + 1] - sigmas[i]) * velocity(x, sigmas[i] * 1000.0)
    return x


def flux_sigmas(steps: int, image_tokens: int):
    """FLUX.1-dev's schedule (diffusers ``FluxPipeline`` with its scheduler's
    config): linspace(1, 1/N, N) shifted by mu(image tokens), then 0."""
    m = (1.15 - 0.5) / (4096 - 256)
    mu = image_tokens * m + (0.5 - m * 256)
    s = [1.0 - i * (1.0 - 1.0 / steps) / max(steps - 1, 1) for i in range(steps)]
    return [math.exp(mu) / (math.exp(mu) + (1.0 / x - 1.0)) for x in s] + [0.0]


def static_shift_sigmas(steps: int, shift: float):
    """HunyuanVideo's schedule: linspace(1, 0, N + 1)[:-1] shifted
    statically, shift s / (1 + (shift - 1) s), then 0."""
    s = [1.0 - i / steps for i in range(steps)]
    return [shift * x / (1.0 + (shift - 1.0) * x) for x in s] + [0.0]
