"""The flash profiling probes' kernels: wrappers and their plain twins.

Counterparts of the two Pallas probes of the JAX repo's root scripts:

* :func:`flash_parts` — kernel 1's tile body with stages switched off
  (``_prof_kernel_parts.py::kernel``/``build``), and ``dma_only``, the loads
  of kernel 1's loop with no S^2 work.  Both run kernel 1's plan at the
  self-attention shape (:data:`PLAN`: the register body, DP 80), whatever
  the shape they are given.  ``parts`` names the stages that stay
  on, as ``build(parts)`` does: ``qk``, ``scale``, ``max``, ``exp``, ``av``.
* :func:`plumb` — q + k + v through the attention layout, none of its math
  (``_prof2_dbg.py::_plumb``).
* :func:`empty` — a kernel that does nothing: timed by CUDA graphs, the
  least a launch costs on the card (no TPU kernel stands behind it).

The kernels are in ``csrc/probes.cu``.  On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor it runs its twin.  The twins are used
by the tests and by ``chip_smoke.py``'s comparisons; the probes themselves
(``compactfusion_tpu_torch/probes/``) time the kernels.

What a switched-off stage computes (the doctored Pallas kernel's stand-in,
in the online form of the CUDA body): without ``qk`` every score of a row is
q[row, 0]; without ``scale`` the exponent takes the raw score; without
``max`` m is 0; without ``exp`` p = s - m; without ``av`` the output is
p[:, :D] over the sum of p of keys 0-7.  The one place the online form
cannot follow the whole-row Pallas kernel is ``exp`` off with ``max`` on:
the Pallas kernel subtracts the row's final max, the CUDA body only knows
the running max, so the twin subtracts the max of keys up to the end of each
64-key tile, as the kernel does (a recorded divergence, pinned by a test).
"""

from __future__ import annotations

import ctypes
from typing import Iterable

import torch

from compactfusion_tpu_torch.ops.flash import _check_qkv, flash_plan

STAGES = ("qk", "scale", "max", "exp", "av")
_BITS = {"qk": 1, "scale": 2, "max": 4, "exp": 8, "av": 16}
#: the stage masks csrc/probes.cu builds (0 is dma_only)
_BUILT = frozenset((31, 0, 31 & ~2, 31 & ~4, 31 & ~8, 31 & ~1, 31 & ~16, 1 | 16))
#: kernel 1's KV tile: the online max of the probes moves once per tile
TILE = 64
#: the plan the probe kernels are built for (``csrc/probes.cu``): kernel 1's
#: at B2 H16 S1024 d72
PLAN = flash_plan(2, 16, 1024, 72)


def stage_mask(parts: Iterable[str]) -> int:
    """The kernel's bit mask of a set of stages; raises on an unknown stage
    or a set that ``csrc/probes.cu`` does not build."""
    parts = tuple(parts)
    unknown = [p for p in parts if p not in _BITS]
    if unknown:
        raise ValueError(f"unknown flash stages {unknown}; the stages are {STAGES}")
    mask = sum(_BITS[p] for p in set(parts))
    if mask not in _BUILT:
        raise ValueError(f"stages {sorted(set(parts))} are not one of the probe's variants")
    return mask


def _parts_math(q, k, v, parts):
    """fp32 (out before rounding, l) of the stage set, whole rows (tile by
    tile for the running max without an exponent); q/k/v (B, S, H, D)."""
    on = set(parts)
    qf, kf, vf = q.float(), k.float(), v.float()
    b, s, h, d = q.shape
    if "qk" in on:
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    else:
        sc = qf[..., 0].transpose(1, 2)[..., None].expand(b, h, s, k.shape[1])
    if "scale" in on:
        sc = sc * d**-0.5
    if "max" not in on:
        m = torch.zeros((), device=q.device)
    elif "exp" in on:
        m = sc.amax(dim=-1, keepdim=True)
    else:  # the running max at the end of each key tile
        tile_max = sc.unflatten(-1, (-1, TILE)).amax(dim=-1)
        m = tile_max.cummax(dim=-1).values.repeat_interleave(TILE, dim=-1)
    p = torch.exp(sc - m) if "exp" in on else sc - m
    if "av" in on:
        acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
        l = p.sum(dim=-1)
    else:
        acc = p[..., :d]
        l = p[..., :8].sum(dim=-1)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.transpose(1, 2), l


def flash_parts_ref(q, k, v, parts, return_l: bool = False):
    """Plain PyTorch twin of :func:`flash_parts`: q/k/v (B, S, H, D) ->
    out (B, S, H, D) in q.dtype (and the fp32 row sums l (B, H, S) with
    ``return_l``; None for ``dma_only``).  ``parts`` empty is ``dma_only``:
    (q + k) + v."""
    stage_mask(parts)
    if not tuple(parts):
        out = plumb_ref(q, k, v)
        return (out, None) if return_l else out
    out, l = _parts_math(q, k, v, parts)
    out = out.to(q.dtype).contiguous()
    return (out, l) if return_l else out


def flash_parts(q, k, v, parts) -> torch.Tensor:
    """Self-attention through kernel 1's tile body with only the stages in
    ``parts`` on (``STAGES`` all on: kernel 1 itself; none: ``dma_only``).
    q/k/v (B, S, H, D) bf16 views (kernel 1's contract), S % 64 == 0 and
    D <= 80 (:data:`PLAN`'s padded head dim); the variants without ``av``
    need S >= D.  The softmax scale is D^-0.5, as
    in the pipeline.  Returns out (B, S, H, D)."""
    mask = stage_mask(parts)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash probe: self-attention, q/k/v of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % TILE:
        raise ValueError(f"flash probe: S must be a multiple of {TILE}, got {q.shape[1]}")
    if mask and not mask & _BITS["av"] and q.shape[1] < q.shape[-1]:
        raise ValueError(f"flash probe without av: S {q.shape[1]} < D {q.shape[-1]}")
    if not q.is_cuda:
        return flash_parts_ref(q, k, v, parts)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.cf_flash_parts_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.data_ptr(), lse.data_ptr(), b, s, h, d, ctypes.c_float(d**-0.5), mask, *PLAN[1:],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_parts")
    flash_parts.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_parts.launches = 0


def plumb_ref(q, k, v) -> torch.Tensor:
    """Plain PyTorch twin of :func:`plumb`: (q + k) + v, rounded to the
    inputs' dtype after each add, contiguous."""
    return ((q + k) + v).contiguous()


def plumb(q, k, v) -> torch.Tensor:
    """q/k/v (B, S, H, D) bf16 views (kernel 1's contract) -> (q + k) + v
    (B, S, H, D) contiguous: each input read once, no S^2 work."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"plumb: q/k/v of one shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.is_cuda:
        return plumb_ref(q, k, v)

    from compactfusion_tpu_torch.ops import _build

    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    status = lib.cf_plumb_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.data_ptr(), b, s, h, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "plumb")
    plumb.launches += 1
    return out


#: kernel launches since the count was last set to 0
plumb.launches = 0


def empty(device) -> None:
    """One launch of the empty kernel on ``device``'s current stream; on the
    CPU, nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        return

    from compactfusion_tpu_torch.ops import _build

    _build.check(_build.load().cf_empty(torch.cuda.current_stream(device).cuda_stream), "empty")
