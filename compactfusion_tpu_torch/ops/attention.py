"""Attention, with and without its log-sum-exp (counterpart of
``compactfusion_tpu/ops/attention.py``).

Routing contract of the JAX package's ``_flash_eligible``: the flash kernel
(``ops/flash.py``) takes a call with no mask and no causal flag, d % 8 == 0,
Sq*Sk >= 256^2 and Sk >= 512, on the accelerator (here: a CUDA tensor).
Every other call of :func:`attn_with_lse` takes the torch math path
(:func:`_attn_math`), which returns an fp32 natural-log LSE.  :func:`sdpa`
drops the LSE, and sends a call with no mask and no causal flag that the
kernel does not take (cross-attention to the text, and every such call on
the CPU) to :func:`_attn_nolse`, as the JAX ``sdpa`` sends it to
``_xla_attn_nolse``; masked and causal calls keep the math path.  That
split is the contract, not a fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.ops.flash import flash_attn_with_lse

NEG_INF = -1e30


def _flash_shape_ok(q_shape, k_shape) -> bool:
    """The shape half of the routing contract (identical to the JAX rule)."""
    _, sq, _, d = q_shape
    sk = k_shape[1]
    return d % 8 == 0 and sq * sk >= 256 * 256 and sk >= 512


def _flash_eligible(q, k, causal, mask) -> bool:
    if causal or mask is not None:
        return False
    if not q.is_cuda:
        return False
    return _flash_shape_ok(q.shape, k.shape)


def _attn_math(q, k, v, scale, causal, mask, kv_lens):
    """Materialised-score attention: fp32 scores from the input values
    (products of bf16 values are exact in fp32, as with JAX's
    ``preferred_element_type``), probabilities rounded to v.dtype for PV.
    The one plain attention of the port; the flash kernel's twin is this
    function without causal flag or mask."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    if scale is None:
        scale = d**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.full_like(scores, NEG_INF)
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = torch.where(keep[None, None], scores, neg)
    if mask is not None:
        scores = torch.where(mask if mask.dim() == 4 else mask[None, None], scores, neg)
    if kv_lens is not None:
        col = torch.arange(sk, device=q.device)[None, None, None, :]
        scores = torch.where(col < kv_lens.to(q.device)[:, None, None, None], scores, neg)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    if mask is not None or kv_lens is not None:
        # a fully masked row would softmax to uniform over NEG_INF scores and
        # return mean(v); it returns 0 with LSE -inf instead
        dead = scores.amax(dim=-1, keepdim=True) <= NEG_INF / 2
        p = torch.where(dead, torch.zeros_like(p), p)
        lse = torch.where(dead[..., 0], torch.full_like(lse, float("-inf")), lse)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _bmm_f32(a, b, scale=1.0):
    """scale * ((B, H, M, K) @ (B, H, K, N)) -> (B, H, M, N) fp32: exact
    products of the input values, fp32 accumulation (as JAX's
    ``preferred_element_type``), the scale applied in the GEMM's epilogue.
    One call per batch on strided (H, M, K) views, so the (B, S, H, D)
    operands are read where they lie, with no permuted copy.  On CUDA,
    bf16 operands go in as they are (``out_dtype``, which the CPU lacks);
    operands of different dtypes are upcast, as JAX promotes them."""
    out = torch.empty(a.shape[:-1] + b.shape[-1:], dtype=torch.float32, device=a.device)
    direct = a.is_cuda and a.dtype == b.dtype != torch.float32
    for i in range(a.shape[0]):
        if direct:
            torch.baddbmm(out[i], a[i], b[i], torch.float32, beta=0, alpha=scale, out=out[i])
        else:
            torch.baddbmm(out[i], a[i].float(), b[i].float(), beta=0, alpha=scale, out=out[i])
    return out


def _attn_nolse(q, k, v, scale, kv_lens):
    """Attention without its LSE, for :func:`sdpa`'s calls with no mask and
    no causal flag that the flash kernel does not take (the counterpart of
    the JAX ``_xla_attn_nolse``).  Its arithmetic is the JAX function's:
    fp32 scores from the input values, the ``kv_lens`` column mask, p
    rounded to v.dtype for the AV product with fp32 accumulation, the row
    sum r of those rounded p in fp32 and the division after the product; a
    row with no valid key gives 0; the output in q.dtype.

    One difference, recorded in ROADMAP.md: the exponent is shifted by the
    row max of the masked scores, where JAX shifts by a Cauchy-Schwarz bound
    and reruns the exact path through ``lax.cond`` when r underflows.  A
    data-dependent branch would cost a host read (or both branches) on every
    call; the row max is one reduction and needs no branch, the outputs
    agree with JAX's to fp32 rounding, and where JAX takes its fallback this
    is already the exact answer.  Against :func:`_attn_math` it saves the
    fp32 copies of q/k/v, the LSE and the dead-row passes over the (B, H,
    Sq, Sk) scores."""
    sk, d = k.shape[1], q.shape[-1]
    if scale is None:
        scale = d**-0.5
    scores = _bmm_f32(q.transpose(1, 2), k.permute(0, 2, 3, 1), scale)
    if kv_lens is not None:
        col = torch.arange(sk, device=q.device)
        scores.masked_fill_(col >= kv_lens.to(q.device)[:, None, None, None], float("-inf"))
    # a row with no valid key has max -inf: clamped to NEG_INF, its exps are
    # exp(-inf) = 0 (not -inf - -inf = nan), so r = 0 and the row comes out 0
    m = scores.amax(dim=-1, keepdim=True).clamp_min_(NEG_INF)
    p = torch.exp(scores.sub_(m), out=torch.empty(scores.shape, dtype=v.dtype, device=q.device))
    out = _bmm_f32(p, v.transpose(1, 2))
    r = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
    # a live row holds exp(0) = 1, so r >= 1 there; a dead row has out = 0
    res = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    torch.div(out, r.clamp_min_(1.0), out=res.transpose(1, 2))
    return res


def attn_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) -> out (B, Sq, H, D) in q.dtype and
    lse (B, H, Sq) fp32.  ``mask``: optional bool (True = attend), (Sq, Sk)
    or broadcastable to (B, H, Sq, Sk); ``kv_lens`` (B,) int: per-batch
    valid key prefix."""
    if _flash_eligible(q, k, causal, mask):
        return flash_attn_with_lse(q, k, v, scale=scale, kv_lens=kv_lens)
    return _attn_math(q, k, v, scale, causal, mask, kv_lens)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention (no LSE) for single-device paths: the flash kernel
    where the contract sends a call to it, :func:`_attn_nolse` for the other
    calls with no mask and no causal flag, else the math path."""
    if not causal and mask is None and not _flash_eligible(q, k, causal, mask):
        return _attn_nolse(q, k, v, scale, kv_lens)
    out, _ = attn_with_lse(q, k, v, scale=scale, causal=causal, mask=mask, kv_lens=kv_lens)
    return out
