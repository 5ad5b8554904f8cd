#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases (each prints its lines; any failure ends the run with a non-zero exit):

1. Device: ``nvidia-smi`` name and power limit, the time ``nvcc`` took
   to build the kernels from ``compactfusion_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel), and what ``ptxas -v`` said of each kernel.
2. Each kernel against its plain PyTorch twin at the shapes the main path
   gives it, with the times of both (CUDA events), of one PyTorch call that
   computes the same function where there is one (``library_ms``), and the
   least time the card could take (``bound_ms``): flash attention, banded
   (window) flash attention, the 1-bit quant pair at K=1 and K=2, the 2-bit
   (INT2) pair on fp32 and bf16 bases.
3. The full-width PixArt-alpha 512 pipeline (28 blocks, dim 1152, S=1024,
   CFG batch 2, 20 DPM-Solver++ steps, SD-VAE decode), random weights with
   spiced AdaLN tables, compression off: 3 requests, each from its own seed.
4. The same pipeline with the 1-bit compressed-ring emulation (ring 8,
   residual 1 + error feedback, warmup 4), from request 1's seed.
5. The same with INT2 through the fused 2-bit kernels.
6. The same with LOW_RANK, rank 4 (subspace iteration; no quant kernel).
7. A per-layer plan on int8-quantized EF caches: layer 0 uncompressed,
   layers 1-13 INT2, layers 14-27 BINARY with a rank-2 scale.
8. DiTFastAttn with an all-FULL plan: the lossless latents, bit for bit.
9. DiTFastAttn with a fixed plan that holds all seven methods after
   ``optimize_plan`` (window 64): the banded kernel on the path.
10. ``calibrate_pixart`` on request 1's text and noise (threshold 0.5,
    window 64), then the request with the calibrated plan.
11. FBCache at threshold 0 (the lossless latents, no skip) and 1e6 (18
    skipped steps), then FBCache 0.12 and TeaCache 0.25.
12. The two ring kernels against their twins, one rank's view with the
    other ranks' blocks or payloads made in this process (each virtual rank
    updates its own copy of the EF stacks, which must stay bit-equal):
    ring 2 at the path's shape (512 tokens per rank, B 2 and B 1) and ring 8
    (128 tokens per rank); BINARY at K=1 and K=2, INT2 and LOW_RANK r4 on
    fp32 stacks, and on int8 stacks at B 1.
13. The pipeline as a ring of 2 processes that share this GPU (a gloo
    group: NCCL refuses two ranks on one device), lossless, unfused and
    through the fused ring kernel, against request 1's lossless latents;
    first cfg 2 alone (each process one CFG half, no ring), which runs the
    model at a ring-2 rank's rows per GEMM without the ring.
14. The same ring with BINARY compression (warmup 4), unfused and through
    the fused compressed ring kernel, against the single-process ring-2
    emulation of the same request, against each other and against lossless;
    both send the same bytes.
15. cfg 2 x ring 2 in 4 processes: fused LOW_RANK r4 on int8 EF caches
    (B 1 per rank) with the consistency check on: the caches stay equal.
16. The flash profiling probes (``compactfusion_tpu_torch/probes``): each
    stage mask of ``flash_parts`` and ``dma_only`` against its twin at B2
    H16 S1024 d72 (``full`` bit-equal to kernel 1 on the same views,
    ``dma_only`` bit-equal to its twin, the others by largest and relative
    error), ``plumb`` bit-equal to its twin on column slices of one qkv
    tensor and timed on enough of them in turn that each call reads from
    DRAM, not L2 (it fails below its bound); then both probes' entry
    points: the stage breakdown of kernel 1 (nine rows and SDPA, per call
    without dispatch cost, on inputs from DRAM) and the full-width
    28-block forward with parts of the block switched off or replaced (per
    forward by CUDA-graph replay and eager), with the block-level
    breakdown.

Phases 4-15 hold their latents against request 1's lossless latents and
their kernel launch counts against the counts the path implies; every
count is set to 0 just before each of phases 3-11, 13-15 and 16's probes
(and the calibration), in every process, and read just after.  A probe
counts a launch when it captures a CUDA graph, so phase 16 reports the
launches the device ran (the captured count times the replays).  The
``launches`` of the pipeline's kernels are those of phases 3-15: what
kernel 1 ran inside the probes is reported beside them, under phase 16's
``launches_of_pipeline_kernels``.  The s/image of phases 13-15 is that of
processes sharing one card, not a ring speed.
Then one JSON line with each kernel's launches on the main path, error and
times, and a last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.  It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

# flash vs twin on bf16 outputs: the output is rounded to bf16 (half an ulp
# is 2^-9 relative) and the kernel rounds running, unnormalised
# probabilities to bf16 where the twin rounds normalised ones, so outputs of
# magnitude ~1 may differ by a few bf16 ulps
FLASH_OUT_ATOL = 2e-2
# both sides take the LSE in fp32 from fp32 scores of the same bf16 inputs;
# only the summation order and exp2/log2 against exp/log differ
FLASH_LSE_ATOL = 1e-3
# quant new_base vs twin: the same fp32 arithmetic; the scale products of
# bf16 factors are exact in fp32 at K=1, and at K=2 the one rounding of their
# sum does not depend on the order
QUANT_NEW_BASE_RTOL = 1e-6
# compressed vs lossless latents (relative Frobenius error): each codec must
# change the result (> 0) but stay close to it
COMPRESSED_REL_ERR_MAX = 0.05
# the ring across ranks vs one process computing the same function (the
# lossless pipeline, the ring-2 emulation, or the other route): only the
# order of the bf16 attention partials differs; the JAX package's dryrun
# puts this bound on its fused vs unfused ring (__graft_entry__.py:250)
RING_REL_MAX = 2e-2
# the probes' matmuls_only divides by l = the sum of a row's raw scores,
# which can be near 0; it is compared on the rows with |l| >= 8 * sqrt(S),
# where one bf16 ulp of the output stays below FLASH_OUT_ATOL
PROBE_L_FLOOR = 8.0
# a stage mask vs its twin, relative Frobenius error: the outputs of most
# masks are averages over 1024 keys, 0.03-0.05 in size, so FLASH_OUT_ATOL
# alone would pass a mask wrong by tens of percent; bf16 rounding of p and
# of the output gives at most 2.3e-3 here on an H100 (full; the other
# masks 0 - 7.4e-4) and 2.6e-3 in the tests' CPU runs of the twins against
# the Pallas probe
PROBE_REL_MAX = 1e-2

# the card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

STEPS = 20
DEPTH = 28
WINDOW = 64
RING = 8
WARMUP = 4
# rows and channels of one ring chunk's K or V: CFG batch 2 x 1024 / 8 tokens, 16 x 72
CHUNK = (2 * 1024 // RING, 1152)
# compress (or decompress) calls of one image per compressed layer: 8 chunks, K and V
CALLS_PER_LAYER = RING * 2 * (STEPS - WARMUP)
# phase 12's compressed-ring cases: (ring, batch, tokens per rank, codec,
# scale rank, int8 bases); ring 2 at the path's shape, ring 8 at S/8
_CODECS = (("binary", -1), ("binary", 2), ("int2", -1), ("lowrank", 4))
CRING_CASES = ([(2, 2, 512, c, r, False) for c, r in _CODECS]
               + [(2, 1, 512, c, r, True) for c, r in _CODECS if r != 2]
               + [(RING, 2, 1024 // RING, c, r, False) for c, r in _CODECS])


def _time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _reset_counts(kernels):
    for fn in kernels:
        fn.launches = 0


def _nbytes(*tensors):
    """Bytes of the tensors' elements (a strided view counts what it shows)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _library(q, k, v, mask=None):
    """One ``scaled_dot_product_attention`` call on the (B, H, S, D) views of
    the same inputs (the yardstick; the port never calls it), and the
    backend PyTorch picks for it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, attn_mask=mask)).name
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)), backend


def check_flash(flash, dev, gen):
    """Flash kernel vs twin at the three path shapes; returns a report."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    dim = 1152
    qkv = rnd(2, 1024, 3 * dim)  # PixArt's q/k/v are column slices of one tensor
    q, k, v = (t.view(2, 1024, 16, 72) for t in qkv.split(dim, dim=-1))
    cases = [
        ("self-attn B2 H16 S1024 d72", (q, k, v), 20),
        ("ring-8 query chunk B2 H16 Sq128 Sk1024 d72", (q[:, :128], k.contiguous(), v.contiguous()), 20),
        ("VAE mid-attn B1 H1 S4096 d512", (rnd(1, 4096, 1, 512), rnd(1, 4096, 1, 512), rnd(1, 4096, 1, 512)), 5),
    ]
    rows = []
    for name, (qq, kk, vv), iters in cases:
        out, lse = flash.flash_attn_with_lse(qq, kk, vv)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attn_with_lse_ref(qq, kk, vv)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ms = _time_ms(lambda: flash.flash_attn_with_lse(qq, kk, vv), iters)
        plain_ms = _time_ms(lambda: flash.flash_attn_with_lse_ref(qq, kk, vv), iters)
        lib, backend = _library(qq, kk, vv)
        library_ms = _time_ms(lib, iters)
        b, sq, h, d = qq.shape
        bound_ms, bound_by = _bound(_nbytes(qq, kk, vv, out, lse), 4 * b * h * sq * kk.shape[1] * d,
                                    PEAK_BF16_FLOPS)
        rows.append({"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[2] flash {name}: out err {err_out:.3e} (tol {FLASH_OUT_ATOL}), lse err "
              f"{err_lse:.3e} (tol {FLASH_LSE_ATOL}); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"SDPA ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash kernel disagrees with its twin at {name}")
    return rows


def band_pairs(s, w):
    """(query, key) pairs with |i - j| <= w over S tokens."""
    return sum(min(s - 1, i + w) - max(0, i - w) + 1 for i in range(s))


def check_window(flash, dev, gen):
    """Banded flash kernel vs twin: PixArt's B2 self-attention on column
    slices of one qkv tensor at w = 64, 4, 0 and 1024, the CFG half (B1) and
    a ragged S=1000; returns a report, with the ratio of the w=64 time to the
    full kernel's at the same shape."""
    import torch

    dim = 1152

    def qkv(b, s):
        t = torch.randn((b, s, 3 * dim), generator=gen, device=dev).to(torch.bfloat16)
        return tuple(x.view(b, s, 16, 72) for x in t.split(dim, dim=-1))

    q, k, v = qkv(2, 1024)
    cases = [(f"B2 H16 S1024 d72 w{w}", (q, k, v), w) for w in (WINDOW, 4, 0, 1024)]
    cases += [(f"CFG half B1 H16 S1024 d72 w{WINDOW}", (q[:1], k[:1], v[:1]), WINDOW),
              (f"ragged B2 H16 S1000 d72 w{WINDOW}", qkv(2, 1000), WINDOW)]
    rows = []
    for name, (qq, kk, vv), w in cases:
        out, lse = flash.flash_attn_window_with_lse(qq, kk, vv, w)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attn_window_with_lse_ref(qq, kk, vv, w)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ms = _time_ms(lambda: flash.flash_attn_window_with_lse(qq, kk, vv, w), 20)
        plain_ms = _time_ms(lambda: flash.flash_attn_window_with_lse_ref(qq, kk, vv, w), 20)
        b, s, h, d = qq.shape
        lib, backend = _library(qq, kk, vv, flash.window_mask(s, w, dev))
        library_ms = _time_ms(lib, 20)
        bound_ms, bound_by = _bound(_nbytes(qq, kk, vv, out, lse), 4 * b * h * d * band_pairs(s, w),
                                    PEAK_BF16_FLOPS)
        rows.append({"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[2] window flash {name}: out err {err_out:.3e} (tol {FLASH_OUT_ATOL}), lse err "
              f"{err_lse:.3e} (tol {FLASH_LSE_ATOL}); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"SDPA with band mask ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        if not (err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL):
            raise AssertionError(f"window flash kernel disagrees with its twin at {name}")
    full_ms = _time_ms(lambda: flash.flash_attn_with_lse(q, k, v), 20)
    print(f"[2] window flash w{WINDOW} / full flash at B2 H16 S1024 d72: {rows[0]['ms']:.4f} / "
          f"{full_ms:.4f} ms = {rows[0]['ms'] / full_ms:.3f}")
    return rows, rows[0]["ms"] / full_ms


def check_quant(quant, codecs, dev, gen, codec, rank, base_dtype):
    """One quant/dequant kernel pair vs its twins at the ring-8 PixArt chunk
    shape, with the scale factors the engine gives it (``rank``: the binary
    scale model, -1 for the mean scale; INT2 always takes the mean scale);
    returns a report."""
    import torch

    n, c = CHUNK
    x = torch.randn((n, c), generator=gen, device=dev).to(base_dtype)
    base = (torch.randn((n, c), generator=gen, device=dev) * 0.9).to(base_dtype)
    delta = x.float() - base.float()
    u, v = codecs._scale_uv(delta, rank) if codec == "binary" else codecs._mean_scale_uv(delta)
    u, v = codecs._wire(u), codecs._wire(v)
    q, dq = getattr(quant, f"{codec}_quant_fastpath"), getattr(quant, f"{codec}_dequant_fastpath")
    q_ref, dq_ref = getattr(quant, f"{codec}_quant_fastpath_ref"), getattr(quant, f"{codec}_dequant_fastpath_ref")
    packed, new_base = q(x, base, u, v)
    x_hat = dq(packed, base, u, v)
    torch.cuda.synchronize()
    ref_packed, ref_base = q_ref(x, base, u, v)
    ref_hat = dq_ref(packed, base, u, v)
    name = f"{codec} N{n} C{c} K{u.shape[1]} {str(base_dtype).replace('torch.', '')}"
    if not torch.equal(packed, ref_packed):
        raise AssertionError(f"{name} quant kernel: packed bytes differ from the twin's")
    rel = ((new_base.float() - ref_base.float()).abs() / ref_base.float().abs().clamp_min(1e-30)).max().item()
    if rel > QUANT_NEW_BASE_RTOL:
        raise AssertionError(f"{name} quant kernel: new_base off the twin by {rel:.3e} relative")
    if not torch.equal(x_hat, new_base):
        raise AssertionError(f"{name}: dequant output is not bit-identical to quant's new_base")
    n, c, kk = x.shape[0], x.shape[1], u.shape[1]
    # fp32 elementwise work per value: delta, the rank-K scale, the level
    # decision and the base update (quant); the scale and the update (dequant)
    quant_bound = _bound(_nbytes(x, base, u, v, packed, new_base), (4 + 2 * kk) * n * c,
                         PEAK_FP32_FLOPS)
    dequant_bound = _bound(_nbytes(packed, base, u, v, x_hat), (3 + 2 * kk) * n * c,
                           PEAK_FP32_FLOPS)
    row = {"shape": name, "new_base_rel_err": rel,
           "quant_bound_ms": quant_bound[0], "quant_bound_by": quant_bound[1],
           "dequant_bound_ms": dequant_bound[0], "dequant_bound_by": dequant_bound[1],
           "max_abs_err_quant": (new_base.float() - ref_base.float()).abs().max().item(),
           "max_abs_err_dequant": (x_hat.float() - ref_hat.float()).abs().max().item(),
           "quant_ms": _time_ms(lambda: q(x, base, u, v), 200),
           "quant_plain_ms": _time_ms(lambda: q_ref(x, base, u, v), 200),
           "dequant_ms": _time_ms(lambda: dq(packed, base, u, v), 200),
           "dequant_plain_ms": _time_ms(lambda: dq_ref(packed, base, u, v), 200)}
    print(f"[2] {name}: packed bytes equal, new_base rel err {rel:.3e} (tol {QUANT_NEW_BASE_RTOL}), "
          f"dequant == new_base bit for bit; quant {row['quant_ms']:.4f} ms (twin "
          f"{row['quant_plain_ms']:.4f}, bound {quant_bound[0]:.5f}), dequant "
          f"{row['dequant_ms']:.4f} ms (twin {row['dequant_plain_ms']:.4f}, bound "
          f"{dequant_bound[0]:.5f})")
    return row


def _shards(gen, dev, ring, b, s_local):
    """Every virtual rank's (q, k, v), column slices of one qkv tensor each,
    as PixArt hands them to attention: (B, S_local, 16, 72) bf16 views."""
    import torch

    dim = 1152
    out = []
    for _ in range(ring):
        qkv = torch.randn((b, s_local, 3 * dim), generator=gen, device=dev).to(torch.bfloat16)
        out.append(tuple(t.view(b, s_local, 16, 72) for t in qkv.split(dim, dim=-1)))
    return out


def _rel(a, b):
    """Largest elementwise |a - b| / |b| (0 where both are 0)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def check_ring_flash(rf, dev, gen):
    """Kernel 7 (one launch per hop) vs its twin, rank 0's view of a ring:
    its queries against its own K/V slices (hop 0) and the contiguous blocks
    the other ranks send, in the order they arrive; timed beside one SDPA
    call on the concatenated K/V.  Returns a report."""
    import torch

    rows = []
    for ring, b, s_local in ((2, 2, 512), (2, 1, 512), (RING, 2, 1024 // RING)):
        shards = _shards(gen, dev, ring, b, s_local)
        q = shards[0][0]
        blocks = [(shards[0][1], shards[0][2])] + [
            (shards[(-s) % ring][1].contiguous(), shards[(-s) % ring][2].contiguous())
            for s in range(1, ring)]
        out, lse = rf.ring_flash_attn_with_lse(q, iter(blocks), ring)
        torch.cuda.synchronize()
        ref_out, ref_lse = rf.ring_flash_attn_with_lse_ref(q, iter(blocks), ring)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        name = f"ring {ring} B{b} H16 Sq{s_local} Sk{ring}x{s_local} d72"
        ms = _time_ms(lambda: rf.ring_flash_attn_with_lse(q, iter(blocks), ring), 20)
        plain_ms = _time_ms(lambda: rf.ring_flash_attn_with_lse_ref(q, iter(blocks), ring), 20)
        k_all = torch.cat([k for k, _ in blocks], dim=1)
        v_all = torch.cat([v for _, v in blocks], dim=1)
        lib, backend = _library(q, k_all, v_all)
        library_ms = _time_ms(lib, 20)
        bound_ms, bound_by = _bound(_nbytes(q, k_all, v_all, out, lse),
                                    4 * b * 16 * s_local * k_all.shape[1] * 72, PEAK_BF16_FLOPS)
        rows.append({"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[12] ring flash {name}: out err {err_out:.3e} (tol {FLASH_OUT_ATOL}), lse err "
              f"{err_lse:.3e} (tol {FLASH_LSE_ATOL}); kernel {ms:.4f} ms ({ring} launches), twin "
              f"{plain_ms:.4f} ms, SDPA on the gathered K/V ({backend}) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        if not (err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL):
            raise AssertionError(f"ring flash kernel disagrees with its twin at {name}")
    return rows


def _stack(gen, dev, ring, n, c, quantized):
    """A random EF stack (R, N, C): fp32, or int8-quantized slots."""
    import torch

    from compactfusion_tpu_torch.compact import codecs

    slots = [torch.randn((n, c), generator=gen, device=dev) * 0.9 for _ in range(ring)]
    if not quantized:
        return torch.stack(slots)
    enc = [codecs.encode_int8(x) for x in slots]
    return codecs.Int8Payload(*(torch.stack(parts) for parts in zip(*enc)))


def _clone(base):
    from compactfusion_tpu_torch.compact import codecs

    if isinstance(base, codecs.Int8Payload):
        return codecs.Int8Payload(*(t.clone() for t in base))
    return base.clone()


def _decoded(base):
    from compactfusion_tpu_torch.compact import codecs

    if isinstance(base, codecs.Int8Payload):
        return base.q.float() * base.scale.float() + base.minv.float()
    return base


def _same(a, b):
    import torch

    from compactfusion_tpu_torch.compact import codecs

    if isinstance(a, codecs.Int8Payload):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def check_compact_ring(rf, dev, gen, ring, b, s_local, codec, rank, quantized):
    """Kernel 8 vs its twin: every virtual rank of a ring of ``ring`` makes
    its fused payload from its own K/V and EF slot, and each runs the kernel
    on its own copy of one stack with the payloads in the order they would
    arrive; rank 0 also runs the twin.  Checks out, LSE and rank 0's new
    stack against the twin, and every rank's stack against every other's
    (bit for bit).  Returns a report with rank 0's time."""
    import torch

    h, d = 16, 72
    n, c = b * s_local, h * d
    shards = _shards(gen, dev, ring, b, s_local)
    kb0, vb0 = _stack(gen, dev, ring, n, c, quantized), _stack(gen, dev, ring, n, c, quantized)
    payloads = [rf.fused_ring_payload(shards[r][1], shards[r][2], rf.decode_slot(kb0, r),
                                      rf.decode_slot(vb0, r), codec, rank) for r in range(ring)]

    def arriving(r):  # the payloads rank r works on, hop by hop
        return iter([payloads[(r - s) % ring] for s in range(ring)])

    def kernel(r, kb, vb):
        return rf.compact_ring_flash(*shards[r], kb, vb, arriving(r), codec=codec, my=r,
                                     ring_size=ring)

    stacks = [(_clone(kb0), _clone(vb0)) for _ in range(ring)]
    out, lse = [kernel(r, *stacks[r]) for r in range(ring)][0]
    torch.cuda.synchronize()
    kr, vr = _clone(kb0), _clone(vb0)
    ref_out, ref_lse = rf.compact_ring_flash_ref(*shards[0], kr, vr, arriving(0), codec=codec,
                                                 my=0, ring_size=ring)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    base_rel = max(_rel(_decoded(stacks[0][0]), _decoded(kr)), _rel(_decoded(stacks[0][1]), _decoded(vr)))
    consistent = all(_same(stacks[r][i], stacks[0][i]) for r in range(ring) for i in range(2))
    kname = {"binary": f"binary K{max(rank, 1)}", "int2": "int2", "lowrank": f"low-rank r{rank}"}[codec]
    name = f"ring {ring} B{b} H16 S{s_local} d72 {kname} {'int8' if quantized else 'fp32'} bases"
    ms = _time_ms(lambda: kernel(0, *stacks[0]), 20)
    plain_ms = _time_ms(lambda: rf.compact_ring_flash_ref(*shards[0], kr, vr, arriving(0), codec=codec,
                                                          my=0, ring_size=ring), 5)
    q, k, v = shards[0]
    payload_bytes = sum(t.numel() * t.element_size() for p in payloads for t in p)
    # each hop reads and writes its source slot of both stacks
    base_bytes = 2 * 2 * ring * n * c * (1 if quantized else 4)
    bound_ms, bound_by = _bound(_nbytes(q, k, v, out, lse) + payload_bytes + base_bytes,
                                4 * b * h * s_local * ring * s_local * d, PEAK_BF16_FLOPS)
    row = {"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
           "new_base_rel_err": base_rel, "ranks_bit_equal": consistent, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[12] compact ring {name}: out err {err_out:.3e} (tol {FLASH_OUT_ATOL}), lse err "
          f"{err_lse:.3e} (tol {FLASH_LSE_ATOL}), new bases rel err {base_rel:.3e} (tol "
          f"{QUANT_NEW_BASE_RTOL}), {ring} ranks' stacks bit-equal: {consistent}; kernel {ms:.4f} ms "
          f"({ring} launches), twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL and base_rel <= QUANT_NEW_BASE_RTOL
            and consistent):
        raise AssertionError(f"compact ring kernel disagrees with its twin at {name}")
    return row


def check_probes(ops_probes, flash, stage_probe, timing, dev, gen):
    """Phase 16's kernel checks: each stage mask of ``flash_parts`` (and
    ``dma_only``) against its twin on the (B, S, H, D) views of bf16
    (B, H, S, D) tensors at B2 H16 S1024 d72, by largest and relative
    error, ``full`` bit for bit against kernel 1 on the same views;
    ``plumb`` bit for bit against its twin on column slices of one qkv
    tensor, timed without dispatch cost on enough qkv tensors in turn that
    each call reads from DRAM.  Returns (flash_parts rows, plumb row)."""
    import math

    import torch

    q, k, v = stage_probe.make_inputs(gen)
    s = q.shape[1]
    kernel1, _ = flash.flash_attn_with_lse(q, k, v)
    rows = []
    for name, parts in stage_probe.VARIANTS.items():
        if parts is None:
            continue
        out = ops_probes.flash_parts(q, k, v, parts)
        torch.cuda.synchronize()
        ref, l = ops_probes.flash_parts_ref(q, k, v, parts, return_l=True)
        diff = (out.float() - ref.float()).abs()
        what = f"{name} B2 H16 S{s} d72"
        if name == "matmuls_only":
            live = l.abs().transpose(1, 2) >= PROBE_L_FLOOR * math.sqrt(s)  # (B, S, H)
            diff = diff[live]
            what += f" on the {live.float().mean().item():.0%} of rows with |l| >= {PROBE_L_FLOOR} sqrt(S)"
        err = diff.max().item()
        ref_f = ref.float()[live] if name == "matmuls_only" else ref.float()
        rel = (diff.norm() / ref_f.norm()).item()
        ok = err == 0.0 if name == "dma_only" else err <= FLASH_OUT_ATOL and rel <= PROBE_REL_MAX
        same_as_kernel1 = torch.equal(out, kernel1)
        if name == "full":
            ok = ok and same_as_kernel1
        plain_ms = _time_ms(lambda: ops_probes.flash_parts_ref(q, k, v, parts), 5)
        rows.append({"name": name, "max_abs_err": err, "rel_err": rel,
                     "twin_rms": (ref_f.norm() / ref_f.numel() ** 0.5).item(), "plain_ms": plain_ms})
        print(f"[16] flash_parts {what}: max abs err vs twin {err:.3e} (tol "
              f"{0.0 if name == 'dma_only' else FLASH_OUT_ATOL}), relative error {rel:.3e} (tol "
              f"{0.0 if name == 'dma_only' else PROBE_REL_MAX}), twin rms {rows[-1]['twin_rms']:.3e}"
              + (f", bit-equal to kernel 1: {same_as_kernel1}" if name == "full" else "")
              + f"; twin {plain_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"flash_parts {name} disagrees with its twin or kernel 1")
    dim = 1152

    def qkv_views():
        qkv = torch.randn((2, 1024, 3 * dim), generator=gen, device=dev).to(torch.bfloat16)
        return tuple(t.view(2, 1024, 16, 72) for t in qkv.split(dim, dim=-1))

    pq, pk, pv = qkv_views()
    out = ops_probes.plumb(pq, pk, pv)
    torch.cuda.synchronize()
    if not torch.equal(out, ops_probes.plumb_ref(pq, pk, pv)):
        raise AssertionError("plumb differs from its twin")
    nbytes = _nbytes(pq, pk, pv, out)
    sets = [(pq, pk, pv)] + [qkv_views() for _ in range(timing.copies(nbytes) - 1)]
    ms, _ = timing.per_call_ms(timing.rotate([lambda t=t: ops_probes.plumb(*t) for t in sets]), 20, 120)
    plain_ms = _time_ms(lambda: ops_probes.plumb_ref(pq, pk, pv), 20)
    bound_ms, bound_by = _bound(nbytes, 0, PEAK_BF16_FLOPS)
    plumb_row = {"shape": "B2 S1024 H16 d72 column slices", "max_abs_err": 0.0, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[16] plumb B2 S1024 H16 d72 (column slices of one qkv tensor): bit-equal to its twin; "
          f"kernel {ms:.4f} ms per call (CUDA graphs of 20 and 120 launches on {len(sets)} qkv tensors "
          f"in turn), twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if ms < bound_ms:
        raise AssertionError(f"plumb took {ms:.4f} ms, below its DRAM bound {bound_ms:.4f} ms")
    return rows, plumb_row


def check_image(img, what):
    import torch

    if tuple(img.shape) != (1, 512, 512, 3):
        raise AssertionError(f"{what}: image shape {tuple(img.shape)}")
    f = img.float()
    if not bool(torch.isfinite(f).all()):
        raise AssertionError(f"{what}: non-finite pixels")
    lo, hi = f.min().item(), f.max().item()
    if lo < 0.0 or hi > 1.0 or hi <= lo:
        raise AssertionError(f"{what}: pixels span [{lo}, {hi}]")
    return lo, hi


def build_models(dev):
    """Full-width PixArt-alpha 512 + SD-VAE with random weights from fixed
    seeds; the zero-init AdaLN tables are spiced so attention (and
    compression error) reaches the output at trained-model-like magnitude."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.pixart import init_pixart, pixart_alpha_512
    from compactfusion_tpu_torch.models.vae import init_vae_decoder, sd_vae

    mcfg, vcfg = pixart_alpha_512(), sd_vae()
    params = init_pixart(torch.Generator(device=dev).manual_seed(0), mcfg)
    spice = np.random.default_rng(99)
    for tree, key in ((params["blocks"], "scale_shift_table"), (params["adaln_single"], "b")):
        tree[key] = torch.from_numpy(spice.standard_normal(tuple(tree[key].shape)) * 0.5).to(
            device=dev, dtype=mcfg.dtype)
    vae_params = init_vae_decoder(torch.Generator(device=dev).manual_seed(1), vcfg)
    return mcfg, vcfg, params, vae_params


def compressed_config(compress_type="binary", **kw):
    """The compressed-ring emulation: ring 8, residual 1 with error
    feedback, warmup 4, the fused quant kernels on; 1-bit by default."""
    from compactfusion_tpu_torch.config import CompactConfig, CompressType

    kw = {"comp_rank": -1, **kw}
    return CompactConfig(enabled=True, compress_type=CompressType(compress_type),
                         warmup_steps=WARMUP, residual=1, error_feedback=True,
                         fastpath=True, simulate_ring=RING, **kw)


def layer_plan_config():
    """Phase 7's per-layer plan on int8-quantized EF caches: WARMUP for the
    first 4 steps, then layer 0 IDENTITY, layers 1-13 INT2, layers 14-27
    BINARY with a rank-2 scale."""
    from compactfusion_tpu_torch.config import CompressType

    def plan(layer, step):
        if step < WARMUP:
            return CompressType.WARMUP
        if layer == 0:
            return CompressType.IDENTITY
        return CompressType.INT2 if layer <= 13 else CompressType.BINARY

    return compressed_config("binary", comp_rank=2, quantized_cache=True, compress_func=plan)


def wire_compression(codecs, plan):
    """Dense bf16 K/V bytes over payload bytes for one image's compressed
    layers: ``plan`` lists (method, comp_rank, layers); IDENTITY layers send
    K/V dense in bf16."""
    import torch

    from compactfusion_tpu_torch.config import CompressType

    dense = CHUNK[0] * CHUNK[1] * 2
    sent = total = 0
    for method, rank, layers in plan:
        nbytes = dense if method == "identity" else codecs.payload_nbytes(
            codecs.encode(torch.ones(CHUNK), CompressType(method), rank=rank))
        sent += nbytes * layers
        total += dense * layers
    return total / sent


def request(pipe, seed):
    """One image: random text (2, 1, 120, text_dim) with a full mask, and
    the noise, both from ``seed``; returns (latents, image, seconds from
    CUDA events)."""
    import torch

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    text = torch.randn((2, 1, 120, pipe.cfg.model.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lat = pipe(text, mask, generator=g, decode=False)
    img = pipe.decode(lat)
    end.record()
    torch.cuda.synchronize()
    return lat, img, start.elapsed_time(end) / 1e3


def compressed_phase(phase, what, pipe, kernels, lossless, expect):
    """One compressed request from request 1's seed, with every launch count
    set to 0 before it; checks the image, the launch counts against
    ``expect`` ({kernel name: count}, any other kernel 0 unless it is the
    flash kernel, which must run) and the latent error against lossless."""
    import torch

    _reset_counts(kernels)
    lat, img, sec = request(pipe, 1)
    counts = {fn.__name__: fn.launches for fn in kernels}
    check_image(img, what)
    for name, count in counts.items():
        want = expect.get(name, 0)
        if name == "flash_attn_with_lse":
            if count < DEPTH * STEPS:
                raise AssertionError(f"{what}: flash launched {count} < {DEPTH * STEPS} times")
        elif count != want:
            raise AssertionError(f"{what}: {name} launched {count} times, expected {want}")
    rel = (torch.linalg.vector_norm(lat - lossless) / torch.linalg.vector_norm(lossless)).item()
    if not 0.0 < rel < COMPRESSED_REL_ERR_MAX:
        raise AssertionError(f"{what}: latent rel err vs lossless {rel} not in (0, {COMPRESSED_REL_ERR_MAX})")
    launched = ", ".join(f"{k} {v}" for k, v in counts.items())
    print(f"[{phase}] {what}: latent rel err vs lossless {rel:.6f} (bound {COMPRESSED_REL_ERR_MAX}), "
          f"{sec:.4f} s/image; launches: {launched}")
    return {"s_per_image": sec, "latent_rel_err": rel, "launches": counts}


def mixed_plan():
    """Phase 9's fixed DiTFastAttn plan: steps 0-1 FULL, then the cycle
    WINDOW, SHARE, FULL_CFG, WINDOW_CFG, FULL over (step + layer), in which
    each FULL_CFG is followed by a WINDOW_CFG that reads its residual (else
    optimize_plan rewrites it)."""
    import numpy as np

    return np.array([[0 if i < 2 else (1, 2, 3, 4, 0)[(i + l) % 5] for l in range(DEPTH)]
                     for i in range(STEPS)], np.int32)


def calibrated_plan(params, mcfg, vcfg, dev, threshold=0.5):
    """Phase 10's DiTFastAttn calibration: ``calibrate_pixart`` on request
    1's text and noise (window 64); returns (plan, seconds)."""
    import torch

    from compactfusion_tpu_torch.cache.fast_attn import calibrate_pixart
    from compactfusion_tpu_torch.pipelines import base
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipelineConfig

    g = torch.Generator(device=dev).manual_seed(1)  # as in request(pipe, 1): text, then noise
    text = torch.randn((2, 1, 120, mcfg.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    cfg = PixArtPipelineConfig(model=mcfg, vae=vcfg, num_steps=STEPS, guidance_scale=4.5,
                               fast_attn_window=WINDOW)
    noise = base.prepare_latents(g, 1, cfg.tokens, mcfg.patch**2 * mcfg.in_channels,
                                 torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = calibrate_pixart(params, cfg, text, mask, threshold=threshold, latents=noise)
    return plan, time.perf_counter() - t0


def plan_launches(table):
    """(full, window) flash launches of one image under an optimized
    DiTFastAttn table: FULL, FULL_CFG and the two NO_RESIDUAL methods launch
    the full kernel once per (step, layer), FULL, FULL_CFG, WINDOW and
    WINDOW_CFG the window kernel once; the VAE adds one full launch."""
    import numpy as np

    return int(np.isin(table, (0, 3, 5, 6)).sum()) + 1, int(np.isin(table, (0, 1, 3, 4)).sum())


def accel_phase(phase, what, pipe, kernels, lossless, full, window, exact=False):
    """One request of a single-device accelerator (DiTFastAttn or a cache)
    from request 1's seed, every launch count set to 0 before it: checks the
    image, the flash and window-kernel launches against ``full`` (or
    ``full(skipped steps)``) and ``window`` (the quant kernels 0), and the
    latents against lossless (equal within 1e-6 with ``exact`` or when a
    cache skipped no step, else different and finite)."""
    import torch

    _reset_counts(kernels)
    lat, img, sec = request(pipe, 1)
    counts = {fn.__name__: fn.launches for fn in kernels}
    check_image(img, what)
    if callable(full):
        full = full(pipe.last_skips)
    want = {"flash_attn_with_lse": full, "flash_attn_window_with_lse": window}
    for name, count in counts.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {count} times, expected {want.get(name, 0)}")
    rel = (torch.linalg.vector_norm(lat - lossless) / torch.linalg.vector_norm(lossless)).item()
    exact = exact or pipe.last_skips == 0  # a cache that skips nothing is the lossless path
    if not (rel <= 1e-6 if exact else 0.0 < rel < float("inf")):
        raise AssertionError(f"{what}: latent rel err vs lossless {rel}")
    print(f"[{phase}] {what}: latent rel err vs lossless {rel:.6e}, {sec:.4f} s/image, skipped "
          f"steps {pipe.last_skips}; launches: {', '.join(f'{k} {v}' for k, v in counts.items())}")
    return {"s_per_image": sec, "latent_rel_err": rel, "skips": pipe.last_skips, "launches": counts}


def port_kernels():
    """Every kernel wrapper of the port (each counts its own launches)."""
    from compactfusion_tpu_torch.ops import flash, probes, quant, ring_flash

    return (flash.flash_attn_with_lse, quant.binary_quant_fastpath, quant.binary_dequant_fastpath,
            quant.int2_quant_fastpath, quant.int2_dequant_fastpath, flash.flash_attn_window_with_lse,
            ring_flash.ring_flash_attn_with_lse, ring_flash.compact_ring_flash,
            probes.flash_parts, probes.plumb)


def ring_compact(compress_type, **kw):
    """The compressed ring across ranks of phases 14-15: residual 1 with
    error feedback, warmup 4, the fused quant kernels on for the unfused
    route."""
    from compactfusion_tpu_torch.config import CompactConfig, CompressType

    return CompactConfig(enabled=True, compress_type=CompressType(compress_type),
                         warmup_steps=WARMUP, residual=1, error_feedback=True, fastpath=True, **kw)


def ring_rank(rank, world, runs):
    """One rank of phases 13-15 (``spawn_local`` on this GPU, gloo): the
    full-width models from the same seeds, then per run (name,
    ParallelConfig kwargs, CompactConfig kwargs or None) request 1 with
    every launch count set to 0 before it; returns per run the whole
    latents, the launch counts, the bytes this rank's ring shifts sent, the
    largest EF cache deviation across the ring and s/image."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh
    from compactfusion_tpu_torch.parallel.ring import ring_shift
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    mcfg, vcfg, params, vae_params = build_models(dev)
    out = {}
    for name, par, compact in runs:
        parallel = ParallelConfig(**par)
        kw = {} if compact is None else {"compact": ring_compact(**compact)}
        cfg = PixArtPipelineConfig(model=mcfg, vae=vcfg, num_steps=STEPS, guidance_scale=4.5,
                                   parallel=parallel, **kw)
        pipe = PixArtPipeline(params, vae_params, cfg, dev, mesh=make_mesh(parallel))
        _reset_counts(kernels)
        ring_shift.nbytes = 0
        compact_ring.max_consistency_dev = 0.0
        lat, img, sec = request(pipe, 1)
        counts = {fn.__name__: fn.launches for fn in kernels}
        check_image(img, f"{name} rank {rank}")
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": counts,
                     "wire_bytes": ring_shift.nbytes, "consistency_dev": compact_ring.max_consistency_dev,
                     "s_per_image": sec}
    return out


def _rel_np(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ring_phase(phase, results, name, lossless, expect, bound, reference=None, low=None):
    """Checks one run of phases 13-15 on every rank: the same whole
    latents, launch counts equal to ``expect`` ({kernel: count}, others 0),
    and the latent error against ``lossless`` (below ``bound``; above
    ``low`` when given) and against ``reference``.  Returns the phase's
    report with the counts summed over ranks."""
    import numpy as np

    runs = [r[name] for r in results]
    lat = runs[0]["latents"]
    for i, r in enumerate(runs):
        if not np.array_equal(r["latents"], lat):
            raise AssertionError(f"{name}: rank {i}'s latents differ from rank 0's")
        for kname, count in r["launches"].items():
            if count != expect.get(kname, 0):
                raise AssertionError(f"{name} rank {i}: {kname} launched {count} times, "
                                     f"expected {expect.get(kname, 0)}")
    rel = _rel_np(lat, lossless)
    if not (rel <= bound and (low is None or rel > low)):
        raise AssertionError(f"{name}: latent rel err vs lossless {rel} outside ({low}, {bound}]")
    rep = {"latent_rel_err_vs_lossless": rel, "s_per_image": [r["s_per_image"] for r in runs],
           "wire_bytes_per_rank": runs[0]["wire_bytes"],
           "consistency_dev": max(r["consistency_dev"] for r in runs),
           "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
           "launches_per_rank": runs[0]["launches"]}
    line = (f"[{phase}] {name} ({len(runs)} processes on one GPU, gloo): latents equal on every "
            f"rank; rel err vs lossless {rel:.6f} (bound {bound}"
            + (f", > {low}" if low is not None else "") + ")")
    if reference is not None:
        ref_name, ref_lat, ref_bound = reference
        rep[f"latent_rel_err_vs_{ref_name}"] = r_ref = _rel_np(lat, ref_lat)
        if not r_ref <= ref_bound:
            raise AssertionError(f"{name}: latent rel err vs {ref_name} {r_ref} > {ref_bound}")
        line += f"; vs {ref_name} {r_ref:.6f} (bound {ref_bound})"
    print(line + f"; s/image {', '.join(f'{s:.4f}' for s in rep['s_per_image'])} (shared card, "
          f"not a ring speed); ring-shift bytes per rank {rep['wire_bytes_per_rank']}; launches per "
          f"rank: {', '.join(f'{k} {v}' for k, v in runs[0]['launches'].items() if v)}")
    return rep


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.cache.fast_attn import optimize_plan
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import _build, flash, quant, ring_flash
    from compactfusion_tpu_torch.ops import probes as ops_probes
    from compactfusion_tpu_torch.parallel.mesh import spawn_local
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
    from compactfusion_tpu_torch.probes import block_parts, flash_parts, timing

    # float32 matmuls and convolutions in full fp32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"kernels built in {_build.last_build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for kernel, said in _build.ptxas_summary(_build.last_build_log).items():
        print(f"[1] ptxas {kernel}: {said}")

    # -- 2. kernels vs twins ----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_rows = check_flash(flash, dev, gen)
    window_rows, window_vs_full = check_window(flash, dev, gen)
    quant_rows = {
        "binary": [check_quant(quant, codecs, dev, gen, "binary", r, torch.float32) for r in (-1, 2)],
        "int2": [check_quant(quant, codecs, dev, gen, "int2", -1, dt)
                 for dt in (torch.float32, torch.bfloat16)],
    }

    # -- 3. full-width pipeline, compression off -----------------------------
    mcfg, vcfg, params, vae_params = build_models(dev)

    def pipeline(compact=None, **kw):
        if compact is not None:
            kw["compact"] = compact
        return PixArtPipeline(params, vae_params, PixArtPipelineConfig(
            model=mcfg, vae=vcfg, num_steps=STEPS, guidance_scale=4.5, **kw), dev)

    pipe = pipeline()
    _reset_counts(kernels)
    lossless = None
    secs = []
    for seed in (1, 2, 3):
        before = flash.flash_attn_with_lse.launches
        lat, img, sec = request(pipe, seed)
        lo, hi = check_image(img, f"request seed {seed}")
        launched = flash.flash_attn_with_lse.launches - before
        if launched < DEPTH * STEPS:
            raise AssertionError(f"request seed {seed}: flash launched {launched} < {DEPTH * STEPS} times")
        if any(fn.launches for fn in kernels[1:]):
            raise AssertionError("compression off, yet a quant or window kernel launched")
        if lossless is None:
            lossless = lat
        secs.append(sec)
        print(f"[3] request seed {seed}: image (1, 512, 512, 3) in [{lo:.4f}, {hi:.4f}], "
              f"flash launches {launched}, {sec:.4f} s/image")
    phases = {"lossless": {"s_per_image": secs,
                           "launches": {fn.__name__: fn.launches for fn in kernels}}}

    # -- 4.-7. full-width pipeline, compressed-ring emulations ---------------
    per_layer = CALLS_PER_LAYER
    runs = [
        (4, "ring-8 binary", compressed_config(), [("binary", -1, DEPTH)],
         {"binary_quant_fastpath": DEPTH * per_layer, "binary_dequant_fastpath": DEPTH * per_layer}),
        (5, "ring-8 int2", compressed_config("int2"), [("int2", -1, DEPTH)],
         {"int2_quant_fastpath": DEPTH * per_layer, "int2_dequant_fastpath": DEPTH * per_layer}),
        (6, "ring-8 low-rank r4", compressed_config("low-rank", comp_rank=4), [("low-rank", 4, DEPTH)], {}),
        (7, "ring-8 per-layer plan (int8 EF caches)", layer_plan_config(),
         [("identity", -1, 1), ("int2", -1, 13), ("binary", 2, 14)],
         {"int2_quant_fastpath": 13 * per_layer, "int2_dequant_fastpath": 13 * per_layer,
          "binary_quant_fastpath": 14 * per_layer, "binary_dequant_fastpath": 14 * per_layer}),
    ]
    for phase, what, compact, plan, expect in runs:
        r = compressed_phase(phase, what, pipeline(compact), kernels, lossless, expect)
        r["wire_compression_vs_bf16"] = wire_compression(codecs, plan)
        print(f"[{phase}] {what}: wire compression vs dense bf16 K/V {r['wire_compression_vs_bf16']:.2f}x")
        phases[what] = r

    # -- 8.-10. DiTFastAttn: per-(step, layer) method plans, window 64 -------
    def plan_pipeline(plan):
        return pipeline(fast_attn_plan=tuple(tuple(int(m) for m in row) for row in plan),
                        fast_attn_window=WINDOW)

    full_plan = np.zeros((STEPS, DEPTH), np.int32)
    phases["fast-attn all FULL"] = accel_phase(
        8, "fast-attn all FULL", plan_pipeline(full_plan), kernels, lossless,
        *plan_launches(optimize_plan(full_plan)), exact=True)
    mixed = mixed_plan()
    if sorted(set(optimize_plan(mixed).ravel().tolist())) != list(range(7)):
        raise AssertionError("the fixed plan does not hold all seven methods after optimize_plan")
    phases["fast-attn mixed plan"] = accel_phase(
        9, "fast-attn mixed plan (all seven methods)", plan_pipeline(mixed), kernels, lossless,
        *plan_launches(optimize_plan(mixed)))

    _reset_counts(kernels)
    calibrated, cal_s = calibrated_plan(params, mcfg, vcfg, dev)
    hist = {m: int((calibrated == m).sum()) for m in range(7)}
    cal_launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"[10] calibrate_pixart (threshold 0.5, window {WINDOW}): {cal_s:.3f} s; methods "
          f"{hist}; optimized {({m: int((optimize_plan(calibrated) == m).sum()) for m in range(7)})}; "
          f"launches {cal_launches}")
    r = accel_phase(10, "fast-attn calibrated plan", plan_pipeline(calibrated), kernels, lossless,
                    *plan_launches(optimize_plan(calibrated)))
    phases["fast-attn calibrated plan"] = dict(r, calibration_s=cal_s, methods=hist,
                                               calibration_launches=cal_launches)

    # -- 11. TeaCache / FBCache -------------------------------------------------
    def cache_full(skips):  # blocks 1-27 skipped on a skipped step; + VAE
        return DEPTH * (STEPS - skips) + skips + 1

    for name, mode, thr in (("fbcache 0", "fbcache", 0.0), ("fbcache 1e6", "fbcache", 1e6),
                            ("fbcache 0.12", "fbcache", 0.12), ("teacache 0.25", "teacache", 0.25)):
        r = accel_phase(11, name, pipeline(cache=CacheAccelConfig(mode=mode, threshold=thr)),
                        kernels, lossless, cache_full, 0, exact=thr == 0.0)
        # threshold 0 never skips; 1e6 skips every step but the first (no
        # probe yet) and the forced last
        want = {0.0: 0, 1e6: STEPS - 2}.get(thr, r["skips"])
        if r["skips"] != want:
            raise AssertionError(f"{name}: {r['skips']} skipped steps, expected {want}")
        phases[name] = r

    # -- 12. the ring kernels vs their twins, one rank's view ------------------
    ring_rows = check_ring_flash(ring_flash, dev, gen)
    cring_rows = [check_compact_ring(ring_flash, dev, gen, *case) for case in CRING_CASES]

    # -- 13.-15. the ring across processes that share this GPU ----------------
    # NCCL refuses two ranks on one device, so the ranks join a gloo group
    # and their ring shifts go through host memory; all compute runs here
    lossless_np = lossless.float().cpu().numpy()
    hops, comp_steps = 2 * DEPTH, STEPS - WARMUP  # ring 2: two hops per self-attention
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    binary = {"compress_type": "binary", "comp_rank": -1}
    two = spawn_local(ring_rank, 2, "gloo", [
        ("cfg2 lossless", {"cfg_degree": 2}, None),
        ("ring2 lossless", ring2, None), ("ring2 lossless fused", fused2, None),
        ("ring2 binary", ring2, binary), ("ring2 binary fused", fused2, binary)], threads=2)
    # no ring: each rank runs the model on its CFG half (1024 rows per GEMM,
    # as in a ring-2 rank, against 2048 in one process)
    phases["cfg2 lossless"] = ring_phase(13, two, "cfg2 lossless", lossless_np,
                                         {"flash_attn_with_lse": DEPTH * STEPS + 1}, RING_REL_MAX)
    phases["ring2 lossless"] = ring_phase(13, two, "ring2 lossless", lossless_np,
                                          {"flash_attn_with_lse": hops * STEPS + 1}, RING_REL_MAX)
    phases["ring2 lossless fused"] = ring_phase(
        13, two, "ring2 lossless fused", lossless_np,
        {"flash_attn_with_lse": 1, "ring_flash_attn_with_lse": hops * STEPS}, RING_REL_MAX)
    # the single-process emulation of the same ring: same codec, chunking and batch
    _reset_counts(kernels)
    sim_lat, sim_img, sim_sec = request(pipeline(ring_compact("binary", comp_rank=-1, simulate_ring=2)), 1)
    check_image(sim_img, "ring-2 emulation")
    sim_np = sim_lat.float().cpu().numpy()
    print(f"[14] single-process ring-2 binary emulation: rel err vs lossless "
          f"{_rel_np(sim_np, lossless_np):.6f}, {sim_sec:.4f} s/image")
    sim_ref = ("the ring-2 emulation", sim_np, RING_REL_MAX)
    phases["ring2 binary"] = ring_phase(
        14, two, "ring2 binary", lossless_np,
        {"flash_attn_with_lse": hops * STEPS + 1, "binary_quant_fastpath": hops * comp_steps,
         "binary_dequant_fastpath": hops * comp_steps}, COMPRESSED_REL_ERR_MAX, sim_ref, low=0.0)
    phases["ring2 binary fused"] = ring_phase(
        14, two, "ring2 binary fused", lossless_np,
        {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp_steps},
        COMPRESSED_REL_ERR_MAX, sim_ref, low=0.0)
    fused_vs = _rel_np(two[0]["ring2 binary fused"]["latents"], two[0]["ring2 binary"]["latents"])
    # wire bytes: the raw fp32 K/V in warmup, then the payloads; the same on both routes
    n, c = 2 * 1024 // 2, 1152
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    want_bytes = DEPTH * (WARMUP * 2 * n * c * 4 + comp_steps * 2 * payload)
    got_bytes = [phases[k]["wire_bytes_per_rank"] for k in ("ring2 binary", "ring2 binary fused")]
    print(f"[14] fused vs unfused latent rel err {fused_vs:.6f} (bound {RING_REL_MAX}); ring-shift "
          f"bytes per rank {got_bytes}, expected {want_bytes} (payload_nbytes {payload} per K or V)")
    if not (fused_vs <= RING_REL_MAX and got_bytes == [want_bytes, want_bytes]):
        raise AssertionError("phase 14: the fused ring drifts from the unfused one or sends other bytes")
    name = "cfg2 x ring2 low-rank r4 int8 fused"
    four = spawn_local(ring_rank, 4, "gloo", [
        (name, {"cfg_degree": 2, "ring_degree": 2, "use_fused_ring": True},
         {"compress_type": "low-rank", "comp_rank": 4, "quantized_cache": True, "check_consistency": True})],
        threads=2)
    phases[name] = ring_phase(15, four, name, lossless_np,
                              {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp_steps},
                              COMPRESSED_REL_ERR_MAX, low=0.0)
    print(f"[15] EF caches across the ring: largest deviation {phases[name]['consistency_dev']}")
    if phases[name]["consistency_dev"] != 0.0:
        raise AssertionError(f"{name}: EF caches differ across ranks")

    # -- 16. the flash profiling probes -----------------------------------------
    part_rows, plumb_row = check_probes(ops_probes, flash, flash_parts, timing, dev, gen)
    _reset_counts(kernels)
    stage_rows = flash_parts.run()
    block_rows = block_parts.run()
    counted = {fn.__name__: fn.launches for fn in kernels}
    ran = {k: sum(r["launches"].get(k, 0) for r in stage_rows + block_rows) for k in counted}
    for k in ("flash_parts", "plumb"):
        if not counted[k]:
            raise AssertionError(f"the probes never launched {k}")
    stage = {r["name"]: r for r in stage_rows}
    if not torch.equal(stage["full"]["out"], stage["real"]["out"]):
        raise AssertionError("the full stage mask differs from kernel 1 in the stage probe")
    for r in stage_rows:
        print(f"[16] stage probe {flash_parts.format_row(r)}")
    for r in block_rows:
        if tuple(r["out"].shape) != (2, 1024, 1152) or not bool(torch.isfinite(r["out"]).all()):
            raise AssertionError(f"block probe {r['name']}: output {tuple(r['out'].shape)} not finite")
        print(f"[16] block probe {block_parts.format_row(r)}")
    breakdown = block_parts.breakdown(block_rows)
    for part, cost, share in breakdown:
        print(f"[16] block breakdown: {part} {cost:.4f} ms per forward ({share:.1%} of full)")
    print(f"[16] launches the device ran: {', '.join(f'{k} {v}' for k, v in ran.items() if v)} "
          f"(counted at capture: {', '.join(f'{k} {v}' for k, v in counted.items() if v)})")

    def plain(rows):
        return [{k: v for k, v in r.items() if k != "out"} for r in rows]

    # the kernels line counts each kernel of the pipeline on the pipeline
    # alone: kernel 1's runs in the probes ("real", the block forward) are
    # reported beside it, not added to it
    probe_kernels = ("flash_parts", "plumb")
    phases["probes"] = {"launches": {k: v if k in probe_kernels else 0 for k, v in ran.items()},
                        "launches_of_pipeline_kernels": {k: v for k, v in ran.items() if k not in probe_kernels},
                        "launches_counted": counted, "stage_rows": plain(stage_rows),
                        "block_rows": plain(block_rows),
                        "block_breakdown": [{"part": p, "ms": c, "share": s} for p, c, s in breakdown]}

    totals = {fn.__name__: sum(p["launches"][fn.__name__] for p in phases.values()) for fn in kernels}
    for name, count in totals.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    def quant_entry(codec, which, line):
        rows = quant_rows[codec]
        return {"name": f"{codec}_{which}_fastpath", "route": "cuda",
                "source": f"compactfusion_tpu_torch/csrc/{codec}_quant.cu",
                "replaces": f"compactfusion_tpu/ops/quant_pallas.py:{line}",
                "launches": totals[f"{codec}_{which}_fastpath"],
                "max_abs_err": max(r[f"max_abs_err_{which}"] for r in rows),
                "ms": rows[0][f"{which}_ms"], "plain_ms": rows[0][f"{which}_plain_ms"],
                "bound_ms": rows[0][f"{which}_bound_ms"], "bound_by": rows[0][f"{which}_bound_by"],
                "library_ms": None, "shapes": rows}

    def flash_entry(name, line, rows, **extra):
        return {"name": name, "route": "cuda", "source": "compactfusion_tpu_torch/csrc/flash_attn.cu",
                "replaces": f"compactfusion_tpu/ops/flash_pallas.py:{line}", "launches": totals[name],
                "max_abs_err": max(r["max_abs_err_out"] for r in rows),
                "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
                "library_ms": rows[0]["library_ms"], "shapes": rows, **extra}

    def ring_entry(name, line, rows):
        return {"name": name, "route": "cuda", "source": "compactfusion_tpu_torch/csrc/ring_flash.cu",
                "replaces": f"compactfusion_tpu/ops/ring_flash_pallas.py:{line}", "launches": totals[name],
                "max_abs_err": max(r["max_abs_err_out"] for r in rows),
                "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
                "library_ms": rows[0].get("library_ms"), "shapes": rows}

    report = {"kernels": [
        flash_entry("flash_attn_with_lse", 593, flash_rows,
                    launches_in_probes=phases["probes"]["launches_of_pipeline_kernels"]["flash_attn_with_lse"]),
        quant_entry("binary", "quant", 118), quant_entry("binary", "dequant", 159),
        quant_entry("int2", "quant", 238), quant_entry("int2", "dequant", 273),
        flash_entry("flash_attn_window_with_lse", 508, window_rows,
                    ms_vs_full_kernel=window_vs_full),
        ring_entry("ring_flash_attn_with_lse", 347, ring_rows),
        ring_entry("compact_ring_flash", 954, cring_rows),
        {"name": "flash_parts", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/probes.cu",
         "replaces": "_prof_kernel_parts.py:69", "launches": totals["flash_parts"],
         "max_abs_err": max(r["max_abs_err"] for r in part_rows),
         "ms": stage["full"]["us_per_call"] / 1e3, "plain_ms": part_rows[0]["plain_ms"],
         "bound_ms": stage["full"]["bound_ms"], "bound_by": stage["full"]["bound_by"],
         "library_ms": stage["sdpa"]["us_per_call"] / 1e3,
         "variants": [dict(r, **{k: stage[r["name"]][k] for k in
                                 ("us_per_call", "us_per_bh", "delta_vs_full_us", "bound_ms", "bound_by")})
                      for r in part_rows]},
        {"name": "plumb", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/probes.cu",
         "replaces": "_prof2_dbg.py:75", "launches": totals["plumb"], "library_ms": None, **plumb_row},
    ], "phases": phases}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
