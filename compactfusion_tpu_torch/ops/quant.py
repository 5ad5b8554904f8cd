"""Error-feedback quant/dequant, 1-bit and 2-bit: the CUDA kernels'
wrappers and plain twins.

Counterpart of ``compactfusion_tpu/ops/quant_pallas.py``.  The kernels are
``csrc/binary_quant.cu`` and ``csrc/int2_quant.cu``.  On CUDA tensors the
wrappers launch them or raise; on CPU tensors they run the plain twins,
which follow the Pallas kernels' arithmetic.  The packed layout is the
grouped one of ``compact/packing.py``: bit i of byte j is channel
i*(C/8)+j, crumb i of byte j is channel i*(C/4)+j.
"""

from __future__ import annotations

from typing import Tuple

import torch

from compactfusion_tpu_torch.compact.packing import pack_2bit, pack_bits, unpack_2bit, unpack_bits

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


def _int2_step(pos, mag, s):
    """sign * level * s with level 2 beyond the threshold, else 0.5."""
    return torch.where(pos, 1.0, -1.0) * torch.where(mag, 2.0, 0.5) * s


def int2_quant_fastpath_ref(x, base, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: delta = x - base in fp32, s = u @ v; code = 2*(delta >= 0)
    + (delta > s or delta < -s), packed 4 per byte; new_base = base + sign *
    {0.5, 2} * s in base.dtype."""
    delta = x.float() - base.float()
    s = _scale(u, v)
    pos = delta >= 0
    mag = (delta > s) | (delta < -s)
    codes = 2 * pos.to(torch.uint8) + mag.to(torch.uint8)
    return pack_2bit(codes), (base.float() + _int2_step(pos, mag, s)).to(base.dtype)


def int2_dequant_fastpath_ref(packed, base, u, v) -> torch.Tensor:
    """Plain twin: base + sign * {0.5, 2} * (u @ v) in base.dtype."""
    codes = unpack_2bit(packed)
    step = _int2_step(codes >= 2, (codes & 1).bool(), _scale(u, v))
    return (base.float() + step).to(base.dtype)


#: packed bytes per thread of the vector kernels (``kVecBytes`` in
#: ``csrc/quant_common.cuh``)
QUANT_VEC_BYTES = 4


def quant_plan(per_byte: int, base, v, *, x=None, packed=None) -> int:
    """The plan of a launch of quant (with ``x``) or dequant (with
    ``packed``), binary (``per_byte`` 8) or INT2 (4), in packed bytes per
    thread.

    :data:`QUANT_VEC_BYTES` is the vector kernel: thread (n, j) takes
    packed bytes j..j+3 of row n, so each of its ``per_byte`` channel
    groups is 4 consecutive channels, one 16-byte access of fp32 (8 of
    bf16), and all its loads are in flight at once.  It runs where the
    packed bytes per row, C/per_byte, are a multiple of QUANT_VEC_BYTES
    and every operand starts aligned for its access: ``base`` and ``x``
    16 bytes, ``v`` 8 bytes (its 8-byte loads), ``packed`` 4 bytes (one
    word a thread; quant allocates its own).  Otherwise 1: the scalar
    kernel, one thread per packed byte.  The C entries hold the same rule
    (``quant_common.cuh::vec_plan_ok``) and refuse a vector plan that
    breaks it."""
    aligned = (not (base.data_ptr() | (0 if x is None else x.data_ptr())) % 16
               and not v.data_ptr() % 8 and (packed is None or not packed.data_ptr() % 4))
    c = base.shape[-1]
    return QUANT_VEC_BYTES if aligned and c % per_byte == 0 and c // per_byte % QUANT_VEC_BYTES == 0 else 1


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


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _quant_launch(entry: str, x, base, u, v, per_byte: int, *plan: int):
    """Check the quant operands and launch ``entry`` of the kernel library
    (``plan``: its plan arguments, before the stream) -> (packed (N,
    C//per_byte) uint8, new_base like base)."""
    from compactfusion_tpu_torch.ops import _build

    if x.dim() != 2 or x.shape[1] % per_byte:
        raise ValueError(f"quant kernel: x must be (N, C) with C % {per_byte} == 0, got {tuple(x.shape)}")
    n, c = x.shape
    _check_nc("x", x, (n, c), x.device)
    _check_nc("base", base, (n, c), x.device)
    _check_uv(u, v, n, c, x.device)
    packed = torch.empty((n, c // per_byte), dtype=torch.uint8, device=x.device)
    new_base = torch.empty_like(base)
    status = getattr(_build.load(), entry)(
        x.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(),
        packed.data_ptr(), new_base.data_ptr(), n, c, u.shape[1],
        int(x.dtype == torch.bfloat16), int(base.dtype == torch.bfloat16), *plan, _stream(x),
    )
    _build.check(status, entry)
    return packed, new_base


def _dequant_launch(entry: str, packed, base, u, v, per_byte: int, *plan: int):
    """Check the dequant operands and launch ``entry`` (``plan``: its plan
    arguments, before the stream) -> (N, C) like base."""
    from compactfusion_tpu_torch.ops import _build

    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError(f"dequant kernel: packed must be a contiguous (N, C//{per_byte}) uint8 tensor")
    n, c = packed.shape[0], packed.shape[1] * per_byte
    _check_nc("base", base, (n, c), packed.device)
    _check_uv(u, v, n, c, packed.device)
    out = torch.empty_like(base)
    status = getattr(_build.load(), entry)(
        packed.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, c, u.shape[1], int(base.dtype == torch.bfloat16), *plan, _stream(packed),
    )
    _build.check(status, entry)
    return out


def binary_quant_fastpath(x, base, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, base (N, C); u (N, K), v (K, C) bf16 scale factors of |x - base|.
    Returns (packed (N, C//8) uint8, new_base (N, C) in base.dtype)."""
    if not x.is_cuda:
        return binary_quant_fastpath_ref(x, base, u, v)
    plan = quant_plan(8, base, v, x=x)
    out = _quant_launch("cf_binary_quant", x, base, u, v, 8, plan)
    binary_quant_fastpath.launches += 1
    if plan > 1:
        binary_quant_fastpath.vec_launches += 1
    return out


def binary_dequant_fastpath(packed, base, u, v) -> torch.Tensor:
    """Unpack + dequant + base add -> (N, C) in base.dtype (= the new base)."""
    if not packed.is_cuda:
        return binary_dequant_fastpath_ref(packed, base, u, v)
    plan = quant_plan(8, base, v, packed=packed)
    out = _dequant_launch("cf_binary_dequant", packed, base, u, v, 8, plan)
    binary_dequant_fastpath.launches += 1
    if plan > 1:
        binary_dequant_fastpath.vec_launches += 1
    return out


def int2_quant_fastpath(x, base, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, base (N, C) with C % 4 == 0; u (N, K), v (K, C) bf16 scale factors
    (K = 1 on the path).  Returns (packed (N, C//4) uint8, new_base (N, C)
    in base.dtype)."""
    if not x.is_cuda:
        return int2_quant_fastpath_ref(x, base, u, v)
    plan = quant_plan(4, base, v, x=x)
    out = _quant_launch("cf_int2_quant", x, base, u, v, 4, plan)
    int2_quant_fastpath.launches += 1
    if plan > 1:
        int2_quant_fastpath.vec_launches += 1
    return out


def int2_dequant_fastpath(packed, base, u, v) -> torch.Tensor:
    """Unpack crumbs + dequant + base add -> (N, C) in base.dtype (= the new base)."""
    if not packed.is_cuda:
        return int2_dequant_fastpath_ref(packed, base, u, v)
    plan = quant_plan(4, base, v, packed=packed)
    out = _dequant_launch("cf_int2_dequant", packed, base, u, v, 4, plan)
    int2_dequant_fastpath.launches += 1
    if plan > 1:
        int2_dequant_fastpath.vec_launches += 1
    return out


#: kernel launches since the counts were last set to 0 (those on the vector
#: plan also apart)
binary_quant_fastpath.launches = 0
binary_quant_fastpath.vec_launches = 0
binary_dequant_fastpath.launches = 0
binary_dequant_fastpath.vec_launches = 0
int2_quant_fastpath.launches = 0
int2_quant_fastpath.vec_launches = 0
int2_dequant_fastpath.launches = 0
int2_dequant_fastpath.vec_launches = 0
