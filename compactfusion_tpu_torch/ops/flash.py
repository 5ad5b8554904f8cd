"""Flash attention with LSE: the CUDA kernels' wrappers and their plain twins.

Counterpart of ``compactfusion_tpu/ops/flash_pallas.py::flash_attn_with_lse``:
the main branch (:func:`flash_attn_with_lse`) and the ``window=`` branch
(:func:`flash_attn_window_with_lse`, banded attention for DiTFastAttn).  The
kernels are in ``csrc/flash_attn.cu``.  On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor it runs its twin.  The TPU tuning flags
of the Pallas wrapper (``fuse_sum``, ``heads_per``, ``bhsd_io``,
``score_bf16``, ``fold_scale``, ``exp_bf16``, ``block_q``/``block_k``) are
not part of this API.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch


def flash_attn_with_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: fp32 scores, fp32 natural-log LSE,
    probabilities rounded to v.dtype before the PV product (as the kernel
    does).  A row with no valid key gives 0 and LSE -inf.  It is the math
    path of ``attn_with_lse`` with no causal flag and no mask."""
    # imported here: ops.attention imports this module to route to the kernel
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, None, kv_lens)


def _check_bshd(name: str, t: torch.Tensor, d: int) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != d:
        raise ValueError(f"flash kernel: {name} must be (B, S, H, {d}), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash kernel: {name} needs a unit head-dim stride, (b, s, h) strides "
            f"that are multiples of 8 and a 16-byte aligned start; got strides "
            f"{t.stride()}"
        )


def _check_qkv(q, k, v) -> None:
    """The kernels' shared contract: bf16 (B, S, H, D) views on one device,
    d % 8 == 0, k and v of one shape that matches q in B, H and D."""
    b, _, h, d = q.shape
    if d % 8:
        raise ValueError(f"flash kernel: head dim must be a multiple of 8, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bshd(name, t, d)
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} is on {t.device}, q on {q.device}")
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")


def flash_attn_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) -> out (B, Sq, H, D) in q.dtype and
    lse (B, H, Sq) fp32.  ``kv_lens`` (B,) int: per-batch valid key prefix.
    ``window``: banded attention |i - j| <= window, delegated to
    :func:`flash_attn_window_with_lse` (Sq == Sk, no ``kv_lens``)."""
    if window is not None:
        if kv_lens is not None:
            raise ValueError("flash kernel: window excludes kv_lens masking")
        return flash_attn_window_with_lse(q, k, v, window, scale=scale)
    if not q.is_cuda:
        return flash_attn_with_lse_ref(q, k, v, scale=scale, kv_lens=kv_lens)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lens_ptr = None
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_lens.shape != (b,):
            raise ValueError(f"flash kernel: kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
        lens_ptr = kv_lens.data_ptr()
    if scale is None:
        scale = d**-0.5

    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.cf_flash_attn_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.data_ptr(), lse.data_ptr(), lens_ptr,
        b, sq, sk, h, d, ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attn_with_lse")
    flash_attn_with_lse.launches += 1
    return out, lse


#: kernel launches since the count was last set to 0
flash_attn_with_lse.launches = 0


def window_mask(s: int, window: int, device=None) -> torch.Tensor:
    """(S, S) banded mask: True where |i - j| <= window."""
    idx = torch.arange(s, device=device)
    return (idx[:, None] - idx[None, :]).abs() <= window


def flash_attn_window_with_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the banded kernel: the math path of
    ``attn_with_lse`` with the band mask |i - j| <= window (every row keeps
    its own key, so no row is empty)."""
    from compactfusion_tpu_torch.ops.attention import _attn_math

    return _attn_math(q, k, v, scale, False, window_mask(q.shape[1], window, q.device), None)


def flash_attn_window_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded self-attention |i - j| <= window with LSE (the ``window=``
    branch of the JAX ``flash_attn_with_lse``): q/k/v (B, S, H, D) -> out
    (B, S, H, D) in q.dtype, lse (B, H, S) fp32.  The kernel visits only the
    KV tiles that each query tile's band touches, so its work scales with
    S * window."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"windowed attention is for self-attention (Sq == Sk), got "
                         f"Sq {q.shape[1]}, Sk {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not q.is_cuda:
        return flash_attn_window_with_lse_ref(q, k, v, window, scale=scale)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.cf_flash_attn_window_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.data_ptr(), lse.data_ptr(),
        b, s, h, d, min(int(window), s), ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attn_window_with_lse")
    flash_attn_window_with_lse.launches += 1
    return out, lse


#: kernel launches since the count was last set to 0
flash_attn_window_with_lse.launches = 0
