"""1-bit error-feedback quant/dequant: the CUDA kernels' wrappers and twins.

Counterpart of ``compactfusion_tpu/ops/quant_pallas.py`` (binary pair).  The
kernels are ``csrc/binary_quant.cu``.  On CUDA tensors the wrappers launch
them or raise; on CPU tensors they run the plain twins.  The packed layout is
the grouped one of ``compact/packing.py``: bit i of byte j is channel
i*(C/8)+j.  The INT2 pair is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from compactfusion_tpu_torch.compact.packing import pack_bits, unpack_bits

_FLOATS = (torch.float32, torch.bfloat16)


def _scale(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u.float() @ v.float()


def binary_quant_fastpath_ref(x, base, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: delta = x - base in fp32, scale = u @ v, signs packed,
    new_base = base + sign * scale in base.dtype."""
    delta = x.float() - base.float()
    scale = _scale(u, v)
    pos = delta >= 0
    new_base = base.float() + torch.where(pos, scale, -scale)
    return pack_bits(pos), new_base.to(base.dtype)


def binary_dequant_fastpath_ref(packed, base, u, v) -> torch.Tensor:
    """Plain twin: base + sign * (u @ v) in base.dtype."""
    pos = unpack_bits(packed).bool()
    scale = _scale(u, v)
    return (base.float() + torch.where(pos, scale, -scale)).to(base.dtype)


def _check_uv(u, v, n, c, device):
    if u.dim() != 2 or v.dim() != 2 or u.shape[0] != n or v.shape != (u.shape[1], c):
        raise ValueError(f"quant kernel: u (N, K) / v (K, C) vs N={n}, C={c}: got {tuple(u.shape)}, {tuple(v.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"quant kernel: {name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"quant kernel: {name} must be contiguous on {device}")


def _check_nc(name, t, shape, device):
    if t.dtype not in _FLOATS:
        raise TypeError(f"quant kernel: {name} must be float32 or bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"quant kernel: {name} must be a contiguous {tuple(shape)} tensor on {device}")


def binary_quant_fastpath(x, base, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, base (N, C); u (N, K), v (K, C) bf16 scale factors of |x - base|.
    Returns (packed (N, C//8) uint8, new_base (N, C) in base.dtype)."""
    if not x.is_cuda:
        return binary_quant_fastpath_ref(x, base, u, v)
    from compactfusion_tpu_torch.ops import _build

    if x.dim() != 2 or x.shape[1] % 8:
        raise ValueError(f"quant kernel: x must be (N, C) with C % 8 == 0, got {tuple(x.shape)}")
    n, c = x.shape
    _check_nc("x", x, (n, c), x.device)
    _check_nc("base", base, (n, c), x.device)
    _check_uv(u, v, n, c, x.device)
    packed = torch.empty((n, c // 8), dtype=torch.uint8, device=x.device)
    new_base = torch.empty_like(base)
    status = _build.load().cf_binary_quant(
        x.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(),
        packed.data_ptr(), new_base.data_ptr(), n, c, u.shape[1],
        int(x.dtype == torch.bfloat16), int(base.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "binary_quant_fastpath")
    binary_quant_fastpath.launches += 1
    return packed, new_base


def binary_dequant_fastpath(packed, base, u, v) -> torch.Tensor:
    """Unpack + dequant + base add -> (N, C) in base.dtype (= the new base)."""
    if not packed.is_cuda:
        return binary_dequant_fastpath_ref(packed, base, u, v)
    from compactfusion_tpu_torch.ops import _build

    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("dequant kernel: packed must be a contiguous (N, C//8) uint8 tensor")
    n, c = packed.shape[0], packed.shape[1] * 8
    _check_nc("base", base, (n, c), packed.device)
    _check_uv(u, v, n, c, packed.device)
    out = torch.empty_like(base)
    status = _build.load().cf_binary_dequant(
        packed.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, c, u.shape[1], int(base.dtype == torch.bfloat16),
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(status, "binary_dequant_fastpath")
    binary_dequant_fastpath.launches += 1
    return out


#: kernel launches since the counts were last set to 0
binary_quant_fastpath.launches = 0
binary_dequant_fastpath.launches = 0
