"""Attention with log-sum-exp output (counterpart of ``compactfusion_tpu/ops/attention.py``).

Routing contract of the JAX package's ``_flash_eligible``: the flash kernel
(``ops/flash.py``) takes a call with no mask and no causal flag, d % 8 == 0,
Sq*Sk >= 256^2 and Sk >= 512, on the accelerator (here: a CUDA tensor).
Every other call takes the torch math path below, which returns an fp32
natural-log LSE.  That split is the contract, not a fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch import ROADMAP_HINT
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
        if q.dtype != torch.bfloat16:
            # the JAX contract runs fp32 through its Pallas kernel; the CUDA
            # kernel takes bf16 only
            raise NotImplementedError(f"{q.dtype} flash attention on the GPU: {ROADMAP_HINT}")
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
    """Plain attention (no LSE) for single-device paths."""
    out, _ = attn_with_lse(q, k, v, scale=scale, causal=causal, mask=mask, kv_lens=kv_lens)
    return out
