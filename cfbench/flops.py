"""Operations of one denoising step, counted from the published shapes.

A matrix product of (M, K) by (K, N) is 2 M K N operations, counted once;
in the dual-stream blocks each token counts only its own stream's weights.
One attention call of B x H heads over Sq queries and Sk keys of width d is
4 B H Sq Sk d (its two products).  Elementwise work is not counted.
"""

from __future__ import annotations


def mmdit_step(m: dict, img_tokens: int, txt_tokens: int, batch: int, context_embedder: bool = True,
               refiner: int = 0) -> dict:
    """One forward of a FLUX-style MMDiT (``m`` as ``reference/layout.py``
    takes it): ``gemm``, ``flash_attention`` (the joint attention of every
    double and single block, on the flash kernel in the port),
    ``other_attention`` (the token refiner's) and ``total``."""
    d, f, h, hd = m["dim"], m["mlp_ratio"] * m["dim"], m["heads"], m["head_dim"]
    s = img_tokens + txt_tokens
    blocks = m["double"] + m["single"]
    gemm = s * blocks * 2 * (4 * d * d + 2 * d * f)  # qkv, out, mlp
    gemm += 2 * (m["double"] * 2 * d * 6 * d + m["single"] * d * 3 * d + d * 2 * d)  # modulation, head
    gemm += 2 * img_tokens * m["in_channels"] * d * 2  # x_embedder, proj_out
    gemm += 2 * (256 * d + d * d) * (2 if m["guidance"] else 1) + 2 * (m["pooled_dim"] * d + d * d)
    if context_embedder:
        gemm += 2 * txt_tokens * m["text_dim"] * d
    other_attn = 0
    if refiner:
        gemm += 2 * (256 * d + d * d) + 2 * (m["text_dim"] * d + d * d) + 2 * txt_tokens * m["text_dim"] * d
        gemm += refiner * (2 * d * 2 * d + txt_tokens * 2 * (4 * d * d + 2 * d * f))
        other_attn = refiner * 4 * h * txt_tokens * txt_tokens * hd
    flash = blocks * 4 * h * s * s * hd
    out = {"gemm": gemm, "flash_attention": flash, "other_attention": other_attn}
    out = {k: batch * v for k, v in out.items()}
    out["total"] = sum(out.values())
    return out
