#!/usr/bin/env python3
"""Check and time kernels 1 to 8 of a checkout at the path's shapes.

    python3 tools/time_flash.py [--root OTHER_ROOT] [--sweep] [--quant] [--tile] [--reg] [--out FILE]

Imports ``compactfusion_tpu_torch`` from ``--root`` (default: this
checkout; e.g. an unpacked ``git archive`` of the parent commit) and the
measuring code from this checkout's ``chip_smoke.py``: the shapes and
inputs of phases 2 and 12 (``flash_cases``, ``window_cases``,
``ring_cases``, ``CRING_CASES`` with ``cring_inputs``), the eager timing,
``graph_ms`` (CUDA graphs on inputs from DRAM), the SDPA yardstick and the
bound.  So two trees are timed by one harness, through the wrappers both
have (``flash_attn_with_lse``, ``flash_attn_window_with_lse``,
``ring_flash_attn_with_lse``, ``compact_ring_flash`` and their twins).
Per shape: the largest error of out and LSE against the twin and out's
relative Frobenius error (kernel 1 held to ``FLASH_OUT_REL_MAX``), eager
``ms``, ``graph_ms``, SDPA's ``library_ms`` (with the band as a bool mask
for kernel 4; none computes kernel 8) and ``bound_ms``.  Kernel 8 writes
its EF stacks, so its twin runs on a fresh copy of the stacks the kernel's
first call started from, and each timed input set has stacks of its own.
Kernels 1, 4 and 7 are also checked, untimed, where the tree splits the
wide body over clusters (``ops/flash.py::WIDE_SPLIT_BUILT``), at wide head
dims off the path (:data:`WIDE_CASES`, :data:`WINDOW_WIDE_CASES`,
:data:`RING_WIDE_CASES`: every padded head dim of one CTA, clusters of 2 to
4 CTAs up to d = 2048, ragged ``kv_lens``, a batch with no key, whose rows
must give LSE -inf as the twin's do), in bf16 (with ``--tile`` also in
fp32).  Kernels 2 and 5 (binary and INT2 quant) at
:data:`QUANT_CASES` (binary: phase 2's K=1 and K=2 cases, ``quant_case``,
first; INT2 on fp32 and bf16 bases at C1152 and C1160, and at K2), with a
few deltas of 0 planted: packed bytes against the twin's, the new base
(``QUANT_NEW_BASE_RTOL``), dequant of the bytes bit-equal to the new base,
the plan where the tree's wrapper has one (:func:`plan_of`), eager ``ms``
(200 calls on one input set) and ``graph_ms``.  Kernels 3 and 6 (binary
and INT2 dequant) at the same cases: the output bit-equal to quant's new
base and to the twin's, the plan, eager ``ms`` and ``graph_ms`` on input
sets each quantized by the tree's own quant kernel.  Where the tree has
the empty kernel (``ops/probes.py::empty``), its time by the same CUDA
graphs, the floor of a launch.  ``--quant`` times only kernels 2, 3, 5 and
6 and the empty kernel.  ``--tile`` checks and times only phase 50's cases
(``chip_smoke.tile_checks``: kernel 1 above d = 512, kernels 4, 7 and 8
above d = 128), in bf16 and in fp32, each against its twin under phase
50's bounds; a case the tree's kernel refuses or gets wrong is recorded
with its ``error`` and the others still run.  ``--reg`` checks and
times only the launches of kernels 1, 7 and 8 at d <= 128 that lose most
to one cuDNN call (:data:`REG_K1_CASES`, :data:`REG_K7_CASES`,
:data:`REG_K8_CASES`: the models' self-attention, ring hops and fused
compressed hops), each against its twin on a (batch 0, 2 heads) slice of
the same launch under phase 2's bounds, with its plan, CTAs, eager ``ms``,
``graph_ms``, SDPA's time, the bound and the ``exp2`` floor (every score's
exp2 on the SFU, 16 a clock per SM, at the card's top SM clock).  With
``--sweep`` (a tree with ``ops/flash.py::flash_plan``), a shape whose plan
takes the register or the wgmma body is also timed at every tile height
built for its padded head dim (``graph_ms_by_warps``), with ``flash_plan``
swapped for one that keeps the body and padded head dim but not the
warps.
Prints the card's name and power limit, one line per shape and one JSON
line (also written to ``--out``); exits non-zero without a CUDA device or
when a kernel disagrees with its twin.
"""

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _smoke():
    """This checkout's chip_smoke.py, by path (the other root may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_harness", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def tile_height(flash, body, warps):
    """Within the block, every launch on ``body`` takes ``warps`` warps per
    CTA: ``flash.flash_plan`` (which the wrappers look up at each call) is
    swapped for one that changes only the warps of the real plan."""
    real = flash.flash_plan

    def plan(*args, **kwargs):
        b, dp, w = real(*args, **kwargs)
        return b, dp, (warps if b == body else w)

    flash.flash_plan = plan
    try:
        yield
    finally:
        flash.flash_plan = real


def errors(smoke, out, lse, ref_out, ref_lse, rel_max=None):
    """(largest error of out, out's relative Frobenius error, largest error
    of LSE over the twin's finite rows) of a flash call against its twin;
    raises where they disagree: past the phase-2 tolerances (``rel_max``:
    the relative one, where given) or on another set of -inf LSE rows."""
    import torch

    err_out = (out.float() - ref_out.float()).abs().max().item()
    rel_out = smoke.rel_fro(out, ref_out)
    fin = torch.isfinite(ref_lse)
    err_lse = (lse[fin] - ref_lse[fin]).abs().max().item()
    if not (err_out <= smoke.FLASH_OUT_ATOL and err_lse <= smoke.FLASH_LSE_ATOL
            and (rel_max is None or rel_out <= rel_max)
            and torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))):
        raise AssertionError(f"the kernel disagrees with its twin: out err {err_out:.3e}, rel "
                             f"{rel_out:.3e}, lse err {err_lse:.3e}")
    return err_out, rel_out, err_lse


def row(smoke, timing, name, run, ref, sets, iters, nbytes, ops, library=None, sweep=None, rel_max=None,
        view=None):
    """Errors of ``run`` against ``ref`` (each a call of one input set) on
    the first set (:func:`errors`; ``view``: the part of run's (out, lse)
    that ref computes), then its eager and graph times,
    ``library``'s ((a call, its backend) or None) and the bound of
    ``nbytes`` of inputs, out and LSE against ``ops`` bf16 operations.
    ``sweep``: (the flash module, the plan, its built (dp, warps) pairs) to
    time the plan's other tile heights."""
    import torch

    out, lse = run(sets[0])
    torch.cuda.synchronize()
    err_out, rel_out, err_lse = errors(smoke, *(view or (lambda o, x: (o, x)))(out, lse), *ref(sets[0]), rel_max)
    bound_ms, bound_by = smoke._bound(nbytes + smoke._nbytes(out, lse), ops, smoke.PEAK_BF16_FLOPS)
    r = {"shape": name, "max_abs_err_out": err_out, "rel_err_out": rel_out, "max_abs_err_lse": err_lse,
         "ms": smoke._time_ms(lambda: run(sets[0]), iters),
         "graph_ms": smoke.graph_ms(timing, [lambda t=t: run(t) for t in sets]),
         "library_ms": None if library is None else smoke._time_ms(library[0], iters),
         "library_backend": None if library is None else library[1],
         "bound_ms": bound_ms, "bound_by": bound_by}
    alts = ""
    if sweep is not None and sweep[1][0] in ("flash_reg_tile", "flash_wgmma_tile"):
        flash, plan, built = sweep
        if plan[0] == "flash_wgmma_tile":
            built = flash.WG_BUILT
        r["plan"], r["graph_ms_by_warps"] = list(plan), {}
        for w in sorted(w for dp, w in built if dp == plan[1]):
            with tile_height(flash, plan[0], w):
                r["graph_ms_by_warps"][w] = smoke.graph_ms(timing, [lambda t=t: run(t) for t in sets])
        alts = "; by warps " + ", ".join(f"{w}: {t:.4f}" for w, t in r["graph_ms_by_warps"].items())
    lib = "no library call" if library is None else f"SDPA ({library[1]}) {r['library_ms']:.4f} ms"
    print(f"{name}: out err {err_out:.3e}, rel {rel_out:.3e}, lse err {err_lse:.3e}; eager "
          f"{r['ms']:.4f} ms, graphs {r['graph_ms']:.4f} ms ({len(sets)} input sets){alts}, {lib}, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return r


#: (B, Sq, Sk, H, d, kv_lens) of kernel 1's checks at the wide head dims
#: off the path (the VAE's d=512 is one of ``flash_cases``): every padded
#: head dim of one CTA, then clusters of 2, 3 and 4 CTAs (d 520 to 2048)
WIDE_CASES = [(2, 200, 300, 3, 136, (300, 17)), (1, 50, 80, 1, 192, (33,)), (1, 96, 256, 2, 256, None),
              (2, 77, 129, 1, 264, (0, 100)), (1, 64, 1000, 2, 384, None), (2, 130, 96, 1, 512, (96, 5)),
              (2, 70, 90, 1, 520, (90, 0)), (1, 40, 300, 2, 1032, None), (1, 33, 64, 1, 1552, (50,)),
              (1, 64, 100, 1, 2048, None)]
#: (B, S, H, d, window) of kernel 4's checks on the wide body: one CTA
#: (d 136, 264), clusters of 2 and 4 (d 576, 2048)
WINDOW_WIDE_CASES = [(1, 100, 2, 136, 4), (2, 70, 1, 264, 0), (1, 130, 1, 576, 9), (1, 64, 1, 2048, 3)]
#: (ring, B, Sq, Sk a hop, H, d) of kernel 7's checks on the wide body
RING_WIDE_CASES = [(2, 1, 50, 70, 2, 200), (3, 1, 40, 33, 1, 600), (2, 2, 33, 40, 1, 1032), (2, 1, 64, 64, 1, 2048)]


def wide_rows(smoke, flash, ring_flash, dev, gen, dtype):
    """Kernels 1, 4 and 7 at :data:`WIDE_CASES`, :data:`WINDOW_WIDE_CASES`
    and :data:`RING_WIDE_CASES` on ``dtype`` q/k/v against their twins,
    untimed, held to ``chip_smoke._limits``: out and LSE, and rows with no
    key -inf as the twin's."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def agree(name, plan, got, ref):
        torch.cuda.synchronize()
        err_out, rel_out, err_lse, ok = smoke._agree(got[0], ref[0], got[1], ref[1])
        print(f"{name}: plan {plan}; out err {err_out:.3e}, rel {rel_out:.3e}, lse err {err_lse:.3e} "
              f"({smoke._tol_text(dtype)})")
        if not ok:
            raise AssertionError(f"{name}: the kernel disagrees with its twin")
        return {"shape": name, "plan": plan, "max_abs_err_out": err_out, "rel_err_out": rel_out,
                "max_abs_err_lse": err_lse}

    tag = str(dtype).replace("torch.", "")
    rows = []
    for b, sq, sk, h, d, lens in WIDE_CASES:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
        kl = None if lens is None else torch.tensor(lens, device=dev, dtype=torch.int32)
        rows.append(agree(f"kernel 1 {tag} B{b} Sq{sq} Sk{sk} H{h} d{d} kv_lens {lens}",
                          flash.flash_plan(b, h, sq, d, elem=q.element_size()),
                          flash.flash_attn_with_lse(q, k, v, kv_lens=kl),
                          flash.flash_attn_with_lse_ref(q, k, v, kv_lens=kl)))
    for b, s, h, d, w in WINDOW_WIDE_CASES:
        q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
        rows.append(agree(f"kernel 4 {tag} B{b} S{s} H{h} d{d} w{w}", flash.flash_plan(b, h, s, d, elem=q.element_size()),
                          flash.flash_attn_window_with_lse(q, k, v, w),
                          flash.flash_attn_window_with_lse_ref(q, k, v, w)))
    for ring, b, sq, sk, h, d in RING_WIDE_CASES:
        q = rnd(b, sq, h, d)
        blocks = [(rnd(b, sk, h, d), rnd(b, sk, h, d)) for _ in range(ring)]
        rows.append(agree(f"kernel 7 {tag} ring {ring} B{b} Sq{sq} Sk{ring}x{sk} H{h} d{d}",
                          flash.flash_plan(b, h, sq, d, elem=q.element_size()),
                          ring_flash.ring_flash_attn_with_lse(q, iter(blocks), ring),
                          ring_flash.ring_flash_attn_with_lse_ref(q, iter(blocks), ring)))
    return rows


#: (codec, (N, C), scale rank, x dtype, base dtype) of the quant pairs:
#: binary (kernels 2 and 3) at phase 2's K1 and K2 first, then bf16
#: operands, the scalar plan at C1160, a short row at C64 and K4 (the
#: vector kernels' runtime-K form); INT2 (kernels 5 and 6) at the path's K1
#: (the mean scale) on fp32 and bf16 bases at both plans, then K2 (the
#: runtime-K form)
QUANT_CASES = ([("binary", *case) for case in (
    ((256, 1152), -1, "float32", "float32"), ((256, 1152), 2, "float32", "float32"),
    ((256, 1160), -1, "float32", "float32"), ((256, 1152), -1, "bfloat16", "float32"),
    ((256, 1152), 2, "float32", "bfloat16"), ((256, 1152), -1, "bfloat16", "bfloat16"),
    ((100, 64), 2, "float32", "float32"), ((256, 1160), 2, "bfloat16", "bfloat16"),
    ((256, 1152), 4, "float32", "float32"))]
    + [("int2", (256, c), -1, dt, dt) for c in (1152, 1160) for dt in ("float32", "bfloat16")]
    + [("int2", (256, 1152), 2, "float32", "float32")])
KERNEL = {("binary", "quant"): "kernel 2 binary", ("binary", "dequant"): "kernel 3 binary",
          ("int2", "quant"): "kernel 5 INT2", ("int2", "dequant"): "kernel 6 INT2"}


def plan_of(quant, wrapper, per_byte, base, v, **operands):
    """The tree's plan of a quant or dequant launch in packed bytes per
    thread (``ops/quant.py::quant_plan``), or None where the tree's
    ``wrapper`` has no vector plan (a wrapper that counts its own launches
    but no ``vec_launches``; where the wrappers count in ``utils/prof.py``,
    all four have one)."""
    vector = hasattr(wrapper, "vec_launches") or not hasattr(wrapper, "launches")
    return quant.quant_plan(per_byte, base, v, **operands) if vector else None


def dequant_row(smoke, timing, quant, codecs, dev, gen, case):
    """Kernel 3 or 6 at one of :data:`QUANT_CASES`: its output against
    quant's new base and the twin's (bit for bit), the plan, eager ms and
    ``graph_ms``, the bound."""
    import torch

    codec, shape, rank, xdt, bdt = case
    xdt, bdt = getattr(torch, xdt), getattr(torch, bdt)
    q, dq = getattr(quant, f"{codec}_quant_fastpath"), getattr(quant, f"{codec}_dequant_fastpath")

    def make():
        x, base, u, v = smoke.quant_case(codecs, dev, gen, codec, rank, bdt, shape)
        packed, new_base = q(x.to(xdt), base, u, v)
        return (packed, base, u, v), new_base

    first, new_base = make()
    packed, base, u, v = first
    out = dq(*first)
    torch.cuda.synchronize()
    twin = getattr(quant, f"{codec}_dequant_fastpath_ref")(*first)
    nbytes = smoke._nbytes(packed, base, u, v, out)
    sets = [first] + [make()[0] for _ in range(timing.copies(nbytes) - 1)]
    n, c = base.shape
    bound_ms, bound_by = smoke._bound(nbytes, (3 + 2 * u.shape[1]) * n * c, smoke.PEAK_FP32_FLOPS)
    name = (f"{KERNEL[codec, 'dequant']} dequant N{n} C{c} K{u.shape[1]} base {str(bdt).replace('torch.', '')}"
            + (f" (quant x {str(xdt).replace('torch.', '')})" if xdt != bdt else ""))
    r = {"shape": name, "plan_bytes_per_thread": plan_of(quant, dq, 8 if codec == "binary" else 4, base, v,
                                                         packed=packed),
         "equal_new_base": torch.equal(out, new_base), "equal_twin": torch.equal(out, twin),
         "ms": smoke._time_ms(lambda: dq(*first), 200),
         "graph_ms": smoke.graph_ms(timing, [lambda t=t: dq(*t) for t in sets]),
         "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"{name}: plan {r['plan_bytes_per_thread']} packed bytes per thread; == new_base "
          f"{r['equal_new_base']}, == twin {r['equal_twin']}; eager {r['ms']:.5f} ms, graphs "
          f"{r['graph_ms']:.5f} ms ({len(sets)} input sets), bound {bound_ms:.5f} ms ({bound_by})")
    if not (r["equal_new_base"] and r["equal_twin"]):
        raise AssertionError(f"{name}: the kernel disagrees with quant's new base or its twin")
    return r


def quant_row(smoke, timing, quant, codecs, dev, gen, case):
    """Kernel 2 or 5 at one of :data:`QUANT_CASES`: packed bytes and new
    base against the twin, dequant of the bytes against the new base, the
    plan, eager ms and ``graph_ms``, the bound."""
    import torch

    codec, shape, rank, xdt, bdt = case
    xdt, bdt = getattr(torch, xdt), getattr(torch, bdt)
    q, dq = getattr(quant, f"{codec}_quant_fastpath"), getattr(quant, f"{codec}_dequant_fastpath")

    def make():
        x, base, u, v = smoke.quant_case(codecs, dev, gen, codec, rank, bdt, shape)
        x = x.to(xdt)
        x[0, :8] = base[0, :8].to(xdt)  # delta == 0 counts as positive
        return x, base, u, v

    x, base, u, v = first = make()
    packed, new_base = q(*first)
    x_hat = dq(packed, base, u, v)
    torch.cuda.synchronize()
    ref_packed, ref_base = getattr(quant, f"{codec}_quant_fastpath_ref")(*first)
    rel = smoke._rel(new_base, ref_base)
    nbytes = smoke._nbytes(x, base, u, v, packed, new_base)
    sets = [first] + [make() for _ in range(timing.copies(nbytes) - 1)]
    n, c = x.shape
    bound_ms, bound_by = smoke._bound(nbytes, (4 + 2 * u.shape[1]) * n * c, smoke.PEAK_FP32_FLOPS)
    name = (f"{KERNEL[codec, 'quant']} quant N{n} C{c} K{u.shape[1]} x {str(xdt).replace('torch.', '')} "
            f"base {str(bdt).replace('torch.', '')}")
    plan = plan_of(quant, q, 8 if codec == "binary" else 4, base, v, x=x)
    r = {"shape": name, "plan_bytes_per_thread": plan, "packed_equal": torch.equal(packed, ref_packed),
         "new_base_rel_err": rel, "dequant_equal": torch.equal(x_hat, new_base),
         "ms": smoke._time_ms(lambda: q(*first), 200),
         "graph_ms": smoke.graph_ms(timing, [lambda t=t: q(*t) for t in sets]),
         "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"{name}: plan {plan} packed bytes per thread; packed bytes equal {r['packed_equal']}, new_base "
          f"rel err {rel:.3e}, dequant == new_base {r['dequant_equal']}; eager {r['ms']:.5f} ms, graphs "
          f"{r['graph_ms']:.5f} ms ({len(sets)} input sets), bound {bound_ms:.5f} ms ({bound_by})")
    if not (r["packed_equal"] and rel <= smoke.QUANT_NEW_BASE_RTOL and r["dequant_equal"]):
        raise AssertionError(f"{name}: the kernel disagrees with its twin")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO, help="the checkout whose kernels to time")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every built tile height of the register body's plans")
    ap.add_argument("--quant", action="store_true",
                    help="time only the quant kernels (2, 3, 5 and 6) and the empty kernel")
    ap.add_argument("--tile", action="store_true",
                    help="check and time only phase 50's cases, in bf16 and fp32")
    ap.add_argument("--reg", action="store_true",
                    help="check and time only the d <= 128 launches of kernels 1, 7 and 8 that lose most to cuDNN")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    smoke = _smoke()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_flash: no CUDA device")
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import _build, flash, quant, ring_flash
    from compactfusion_tpu_torch.ops import probes as ops_probes
    from compactfusion_tpu_torch.probes import timing

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    _build.load()
    print(f"{flash.__file__}: kernels built in {_build.last_build_seconds:.1f} s")
    for kernel, said in _build.ptxas_summary(_build.last_build_log).items():
        print(f"ptxas {kernel}: {said}")
    if args.sweep and not hasattr(flash, "REG_BUILT"):
        raise SystemExit(f"time_flash: {args.root} has no register-body plans to sweep")

    def sweep(b, h, sq, d, kernel=1, **kw):
        return (flash, smoke._plan(flash, b, h, sq, d, 2, kernel), flash.REG_BUILT) if args.sweep else None

    def sets_of(make, first, nbytes):
        return [first] + [make() for _ in range(timing.copies(nbytes) - 1)]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.reg:
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.strip()
        print(f"max SM clock {clock} MHz")
        rows = reg_rows(smoke, timing, flash, ring_flash, dev, gen, sweep, sets_of, float(clock) * 1e6)
    elif args.tile:
        rows = tile_rows(smoke, timing, flash, ring_flash, dev, gen)
        if hasattr(flash, "WIDE_SPLIT_BUILT"):
            rows += [r for dtype in (torch.bfloat16, torch.float32)
                     for r in wide_rows(smoke, flash, ring_flash, dev, gen, dtype)]
    else:
        rows = [] if args.quant else flash_rows(smoke, timing, flash, ring_flash, dev, gen, sweep, sets_of)
        rows += [quant_row(smoke, timing, quant, codecs, dev, gen, case) for case in QUANT_CASES]
        rows += [dequant_row(smoke, timing, quant, codecs, dev, gen, case) for case in QUANT_CASES]
    if hasattr(ops_probes, "empty") and not (args.tile or args.reg):
        floor = smoke.launch_floor_ms(ops_probes, timing, dev)
        rows.append({"shape": "empty kernel", "graph_ms": floor})
        print(f"empty kernel: graphs {floor:.5f} ms per launch")
    report = {"card": card, "root": str(args.root.resolve()), "rows": rows}
    line = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    if any("error" in r for r in rows):
        raise SystemExit("time_flash: a kernel failed or disagrees with its twin")


#: (name, B, S, H, d) of kernel 1's self-attention launches at d <= 128
#: that lose most to one cuDNN call (PERF.md §6)
REG_K1_CASES = [("PixArt-alpha 512", 2, 1024, 16, 72), ("SD3-medium joint", 2, 4293, 24, 64),
                ("HunyuanDiT v1.2", 2, 4096, 16, 88), ("PixArt-Sigma 2K", 2, 16384, 16, 72),
                ("FLUX.1-dev", 1, 4608, 24, 128), ("HunyuanVideo", 1, 18616, 24, 128),
                ("CogVideoX-2b", 2, 17776, 30, 64), ("ConsisID", 2, 17776, 48, 64), ("Step-Video-T2V", 2, 18972, 48, 128)]
#: (name, ring, B, Sq, Sk a hop, H, d) of kernel 7's ring hops (rank 0's
#: queries hold the text rows in front of its image rows), and PixArt's
#: ring-2 hops at B2 and B1 and ring-8 hop, where the tile height changes
REG_K7_CASES = [("FLUX ring 2", 2, 1, 2560, 2048, 24, 128), ("FLUX U2 x R2", 2, 1, 3072, 2048, 12, 128),
                ("HunyuanVideo ring 2", 2, 1, 2296, 2040, 24, 128), ("CogVideoX ring 2", 2, 1, 9001, 8775, 30, 64),
                ("PixArt ring 2", 2, 2, 512, 512, 16, 72), ("PixArt ring 2 B1", 2, 1, 512, 512, 16, 72),
                ("PixArt ring 8", 8, 2, 128, 128, 16, 72)]
#: (name, B, Sq, S a rank, H, d) of kernel 8 (BINARY, K1, fp32 EF stacks)
#: at FLUX's and CogVideoX's ring 2
REG_K8_CASES = [("FLUX ring 2", 1, 2560, 2048, 24, 128), ("CogVideoX ring 2", 1, 9001, 8775, 30, 64)]


def reg_rows(smoke, timing, flash, ring_flash, dev, gen, sweep, sets_of, clock_hz):
    """The rows of ``--reg``: kernels 1 and 7 at :data:`REG_K1_CASES` and
    :data:`REG_K7_CASES`, each checked on its (batch 0, 2 heads) slice, and
    kernel 8 at :data:`REG_K8_CASES` (its twin on the whole launch, stacks
    and all), each with its plan, CTAs and ``exp2_floor_ms``."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def head_slice(out, lse):
        return out[:1, :, :2], lse[:1, :2]

    def floor(scores):
        return scores / (16 * 132 * clock_hz) * 1e3

    def extra(r, kernel, b, h, sq, d, scores):
        plan = smoke._plan(flash, b, h, sq, d, 2, kernel)
        r.update(plan=list(plan), ctas=smoke._ctas(flash, plan, b, h, sq), exp2_floor_ms=floor(scores))
        print(f"  plan {plan}, {r['ctas']} CTAs; exp2 floor {r['exp2_floor_ms']:.4f} ms")
        return r

    rows = []
    for name, b, s, h, d in REG_K1_CASES:
        make = (lambda: smoke._qkv_views(gen, dev, b, s, h, d)) if s <= 4096 else \
            (lambda: (rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)))
        q, k, v = first = make()
        iters = 3 if s > 10000 else 20
        r = row(smoke, timing, f"kernel 1 {name} B{b} H{h} S{s} d{d}", lambda t: flash.flash_attn_with_lse(*t),
                lambda t: flash.flash_attn_with_lse_ref(*(x[:1, :, :2] for x in t)),
                sets_of(make, first, smoke._nbytes(q, k, v, q)), iters, smoke._nbytes(q, k, v),
                4 * b * h * s * s * d, smoke._library(q, k, v), sweep(b, h, s, d), smoke.FLASH_OUT_REL_MAX,
                view=head_slice)
        rows.append(extra(r, 1, b, h, s, d, b * h * s * s))
        del q, k, v, first
        torch.cuda.empty_cache()
    for name, ring, b, sq, sk, h, d in REG_K7_CASES:
        def make(ring=ring, b=b, sq=sq, sk=sk, h=h, d=d):
            return rnd(b, sq, h, d), [(rnd(b, sk, h, d), rnd(b, sk, h, d)) for _ in range(ring)]

        q, blocks = first = make()
        k_all = torch.cat([k for k, _ in blocks], dim=1)
        v_all = torch.cat([v for _, v in blocks], dim=1)
        r = row(smoke, timing, f"kernel 7 {name} B{b} H{h} Sq{sq} Sk{ring}x{sk} d{d}",
                lambda t, n=ring: ring_flash.ring_flash_attn_with_lse(t[0], iter(t[1]), n),
                lambda t, n=ring: ring_flash.ring_flash_attn_with_lse_ref(
                    t[0][:1, :, :2], iter([(k[:1, :, :2], v[:1, :, :2]) for k, v in t[1]]), n),
                sets_of(make, first, smoke._nbytes(q, k_all, v_all, q)), 20 if sq < 4000 else 5,
                smoke._nbytes(q, k_all, v_all), 4 * b * h * sq * ring * sk * d, smoke._library(q, k_all, v_all),
                sweep(b, h, sq, d, kernel=7), smoke.FLASH_OUT_REL_MAX, view=head_slice)
        rows.append(extra(r, 7, b, h, sq, d, b * h * sq * ring * sk))
        del q, blocks, first, k_all, v_all
        torch.cuda.empty_cache()
    for name, b, sq, s_local, h, d in REG_K8_CASES:
        shards, kb0, vb0, payloads = smoke.cring_inputs(ring_flash, gen, dev, 2, b, s_local, "binary", -1, False,
                                                        h, d, sq)
        q, k, v = shards[0]
        stack_bytes = 2 * 2 * b * s_local * h * d * 4

        def run(t, shards=shards, payloads=payloads):
            return ring_flash.compact_ring_flash(*shards[0], *t, smoke.arriving(payloads, 0), codec="binary", my=0,
                                                 ring_size=2)

        def ref(t, shards=shards, payloads=payloads, kb0=kb0, vb0=vb0):
            return ring_flash.compact_ring_flash_ref(*shards[0], smoke._clone(kb0), smoke._clone(vb0),
                                                     smoke.arriving(payloads, 0), codec="binary", my=0, ring_size=2)

        def stacks(kb0=kb0, vb0=vb0):
            return smoke._clone(kb0), smoke._clone(vb0)

        payload_bytes = sum(smoke._nbytes(*p_) for p_ in payloads)
        r = row(smoke, timing, f"kernel 8 {name} BINARY K1 fp32 stacks B{b} H{h} Sq{sq} S{s_local} d{d}", run, ref,
                sets_of(stacks, stacks(), stack_bytes + smoke._nbytes(q, k, v)), 5,
                smoke._nbytes(q, k, v) + payload_bytes + 2 * stack_bytes, 4 * b * h * sq * 2 * s_local * d,
                rel_max=smoke.FLASH_OUT_REL_MAX)
        rows.append(extra(r, 7, b, h, sq, d, b * h * sq * 2 * s_local))
        del shards, kb0, vb0, payloads, q, k, v
        torch.cuda.empty_cache()
    return rows


def tile_rows(smoke, timing, flash, ring_flash, dev, gen):
    """Phase 50's cases (``chip_smoke.tile_checks``) in bf16, then fp32:
    every case's rows, or, where its launch is refused or it disagrees
    with its twin, one row with the ``error``."""
    import torch

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for what, name, check in smoke.tile_checks(flash, ring_flash, dev=dev, gen=gen, timing=timing,
                                                   dtype=dtype):
            try:
                got = check()
            except (AssertionError, RuntimeError) as e:
                torch.cuda.synchronize()
                print(f"{what} {name}: failed: {e}")
                rows.append({"kernel": what, "shape": name, "error": str(e)})
                continue
            rows += [dict(r, kernel=what) for r in got]
    return rows


def flash_rows(smoke, timing, flash, ring_flash, dev, gen, sweep, sets_of):
    """The rows of kernels 1, 4, 7 and 8 (and kernel 1's wide cases)."""
    import torch

    rows = []
    for name, make, iters in smoke.flash_cases(gen, dev):
        q, k, v = first = make()
        b, sq, h, d = q.shape
        rows.append(row(smoke, timing, f"kernel 1 {name}", lambda t: flash.flash_attn_with_lse(*t),
                        lambda t: flash.flash_attn_with_lse_ref(*t),
                        sets_of(make, first, smoke._nbytes(q, k, v, q)), iters, smoke._nbytes(q, k, v),
                        4 * b * h * sq * k.shape[1] * d, smoke._library(q, k, v), sweep(b, h, sq, d),
                        smoke.FLASH_OUT_REL_MAX))
    if hasattr(flash, "WIDE_SPLIT_BUILT"):
        rows += wide_rows(smoke, flash, ring_flash, dev, gen, torch.bfloat16)
    for name, make, w in smoke.window_cases(gen, dev):
        q, k, v = first = make()
        b, s, h, d = q.shape
        rows.append(row(smoke, timing, f"kernel 4 {name}",
                        lambda t, w=w: flash.flash_attn_window_with_lse(*t, w),
                        lambda t, w=w: flash.flash_attn_window_with_lse_ref(*t, w),
                        sets_of(make, first, smoke._nbytes(q, k, v, q)), 20, smoke._nbytes(q, k, v),
                        4 * b * h * d * smoke.band_pairs(s, w),
                        smoke._library(q, k, v, flash.window_mask(s, w, dev)), sweep(b, h, s, d)))
    for (ring, b, s_local), make in smoke.ring_cases(gen, dev):
        q, blocks = first = make()
        k_all = torch.cat([k for k, _ in blocks], dim=1)
        v_all = torch.cat([v for _, v in blocks], dim=1)
        rows.append(row(smoke, timing, f"kernel 7 ring {ring} B{b} H16 Sq{s_local} Sk{ring}x{s_local} d72",
                        lambda t, n=ring: ring_flash.ring_flash_attn_with_lse(t[0], iter(t[1]), n),
                        lambda t, n=ring: ring_flash.ring_flash_attn_with_lse_ref(t[0], iter(t[1]), n),
                        sets_of(make, first, smoke._nbytes(q, k_all, v_all, q)), 20,
                        smoke._nbytes(q, k_all, v_all), 4 * b * 16 * s_local * k_all.shape[1] * 72,
                        smoke._library(q, k_all, v_all), sweep(b, 16, s_local, 72)))
    for case in smoke.CRING_CASES:
        ring, b, s_local, codec, rank, quantized = case
        shards, kb0, vb0, payloads = smoke.cring_inputs(ring_flash, gen, dev, *case)
        q, k, v = shards[0]
        n, c = b * s_local, 16 * 72
        stack_bytes = 2 * ring * n * c * (1 if quantized else 4)

        def run(t, case=case, shards=shards, payloads=payloads):
            return ring_flash.compact_ring_flash(*shards[0], *t, smoke.arriving(payloads, 0), codec=case[3],
                                                 my=0, ring_size=case[0])

        def ref(t, case=case, shards=shards, payloads=payloads, kb0=kb0, vb0=vb0):
            return ring_flash.compact_ring_flash_ref(*shards[0], smoke._clone(kb0), smoke._clone(vb0),
                                                     smoke.arriving(payloads, 0), codec=case[3], my=0,
                                                     ring_size=case[0])

        def stacks(kb0=kb0, vb0=vb0):
            return smoke._clone(kb0), smoke._clone(vb0)

        payload_bytes = sum(smoke._nbytes(*p) for p in payloads)
        rows.append(row(smoke, timing, f"kernel 8 {smoke.cring_name(*case)}", run, ref,
                        sets_of(stacks, stacks(), stack_bytes + smoke._nbytes(q, k, v)), 20,
                        smoke._nbytes(q, k, v) + payload_bytes + 2 * stack_bytes,
                        4 * b * 16 * s_local * ring * s_local * 72))
    return rows


if __name__ == "__main__":
    main()
