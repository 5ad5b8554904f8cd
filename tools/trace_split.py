#!/usr/bin/env python3
"""Where a benchmark cell's device time goes, by the port's own spans; and
what the tracer costs switched on.

    python3 tools/trace_split.py --out build/trace_split.json
                                 [--cells flux-1024 hunyuanvideo-544p-129f]
                                 [--pairs 3] [--seed N] [--cpu]

For each cell of ``BENCHMARK.json`` it builds the benchmark's program
(``cfbench/``), profiles one request as a ``--trace 1`` run does
(``cfbench/harness.py::_StepProfile``) and joins the program's spans to the
trace (``cfbench/spans.py``).  It prints and writes:

* ``metrics``: every per-layer metric the cell's readers give on that trace;
* ``breakdown``: per innermost span, the device ms a step outside matrix
  products and attention, all device ms a step, the idle ms a step of the
  gaps whose next work it launched, and ``covered_share``, the share of the
  window's device time under some span;
* ``split_check``: the four part metrics plus the remainder (the spans
  they do not read: ``qkv``, ``embed``, ``head``, ``scheduler``,
  ``refiner`` and the bodies of the families, steps and request) against
  ``elementwise_ms``;
* ``clock``: the profiler's host events that start inside a block's part
  spans, how many lie inside exactly one of them (the spans and the trace
  share a clock), and the least margin to a part's edge;
* the flash routes on the ``attention`` spans and the ``flash.body.*``
  counters;
* ``on_cost``: request seconds with the tracer switched on
  (``Profiler.enable()``, no profiler session) and off, alternated
  off, on, on, off, ..., and the ``Profiler.summary()`` of the last request
  switched on.

With the card's ``nvidia-smi`` name and power limit.  ``--cpu`` rehearses
at the sizes of the benchmark's CPU tests (``cfbench/tests/conftest.py``).
"""

import argparse
import collections
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: a block's part spans
PARTS = ("modulate", "qkv", "qk_norm_rope", "attention", "out_gate", "ffn_gate")
#: the part spans the part metrics read (``qkv`` is left to the remainder)
METRIC_SPANS = ("modulate", "qk_norm_rope", "attention", "out_gate", "ffn_gate")
#: the part metrics (``cfbench/metrics``), without their cell's suffix
PART_METRICS = ("modulate_ms", "qk_norm_rope_ms", "gate_residual_ms", "attention_glue_ms")


def log(msg):
    print(f"[trace_split {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def breakdown(run):
    """Per innermost span name: device ms a step outside ``PRODUCTS``, all
    device ms a step, and idle ms a step of the gaps it launched after;
    and the share of the window's device time under some span.  None
    without spans in the window (``cfbench/spans.py::joined``)."""
    from cfbench.spans import joined
    from cfbench.trace import PRODUCTS, category

    j = joined(run)
    if j is None:
        return None
    rest, every, idle = collections.Counter(), collections.Counter(), collections.Counter()
    for (name, _, d, _, _), ch in zip(j.trace.device, j.chains):
        leaf = ch[0] if ch else "no span"
        every[leaf] += d
        if category(name) not in PRODUCTS:
            rest[leaf] += d
    for ns, ch in j.gaps:
        idle[ch[0] if ch else "no span"] += ns
    total = sum(d for _, _, d, _, _ in j.trace.device)
    covered = sum(d for (_, _, d, _, _), ch in zip(j.trace.device, j.chains) if ch)

    def per_step(c):
        return {k: v / j.steps / 1e6 for k, v in c.most_common()}

    return {"steps": j.steps, "outside_products_ms": per_step(rest), "device_ms": per_step(every),
            "idle_ms": per_step(idle), "covered_share": covered / total if total else None}


def split_check(metrics, split):
    """The part metrics and the remainder against ``elementwise_ms``."""
    key = next((k for k in metrics if k.startswith("elementwise_ms.")), None)
    if key is None:
        return None
    suffix, ew = key[len("elementwise_ms"):], metrics[key]
    got = [metrics.get(p + suffix) for p in PART_METRICS]
    if ew is None or None in got or split is None:
        return None
    remainder = sum(v for k, v in split["outside_products_ms"].items() if k not in METRIC_SPANS)
    return {"parts": sum(got), "remainder": remainder, "elementwise": ew, "rel": (sum(got) + remainder) / ew - 1}


def clock_check(prof, spans):
    """Host events (operators and runtime calls) that start inside a
    block's part spans: how many lie inside exactly one part span, how many
    do not (with up to 5 examples), and the least margin to a part's edge
    (ns)."""
    from cfbench.trace import _kind

    evs = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), kind, ev.name())
           for ev in prof.profiler.kineto_results.events()
           if (kind := _kind(ev)) in ("cpu_op", "cuda_runtime", "cuda_driver")]
    ok = bad = 0
    margin, examples = None, []
    for fam in (s for s in spans if s.name in ("double_blocks", "single_blocks")):
        kids = sorted((s for s in spans if s.parent == fam.id and s.name in PARTS), key=lambda s: s.start_ns)
        if not kids:
            continue
        lo, hi = kids[0].start_ns, kids[-1].end_ns
        for a, b, kind, name in evs:
            if not lo <= a < hi:
                continue
            inside = [k for k in kids if k.start_ns <= a and b <= k.end_ns]
            if len(inside) == 1:
                ok += 1
                m = min(a - inside[0].start_ns, inside[0].end_ns - b)
                margin = m if margin is None else min(margin, m)
            else:
                bad += 1
                if len(examples) < 5:
                    near = min(kids, key=lambda k: min(abs(a - k.start_ns), abs(a - k.end_ns)))
                    examples.append([kind, name, a - near.start_ns, near.end_ns - b, near.name])
    return {"inside_one_part": ok, "not": bad, "min_margin_ns": margin, "examples": examples}


def build(name, seed, dev):
    """The cell's program, warmed up, and its request pool."""
    from cfbench import spec, timing
    from cfbench import traffic as traffic_gen

    cell = spec.load_cell(ROOT, name)
    if dev == "cpu":
        sys.path.insert(0, str(ROOT / "cfbench" / "tests"))
        from conftest import tiny_cell

        cell = tiny_cell(name, "float32")
    mod = cell.module
    shapes = mod.input_shapes(cell.cfg, cell.traffic)
    params = mod.build(cell.cfg, seed, dev)
    pool = traffic_gen.requests(cell.traffic, shapes, seed, dev)
    program = mod.Program(cell.cfg, cell.traffic, params, dev)
    program.warm_up(pool[0])
    timing.synchronize(dev)
    return cell, program, pool


def traced(cell, program, pool, dev):
    """One request profiled as a ``--trace 1`` run profiles it, joined to
    the program's spans."""
    import torch

    from cfbench import harness, peaks, timing
    from cfbench.trace import from_profiler
    from compactfusion_tpu_torch.utils.prof import Profiler

    Profiler.enable(False)
    Profiler.reset()
    ctx = harness._StepProfile(dev)
    t = time.perf_counter()
    program.request(pool[1 % len(pool)], ctx)
    timing.synchronize(dev)
    host = time.perf_counter() - t
    tr = from_profiler(ctx.prof, program.steps)
    spans = Profiler.spans()
    run = harness.Run(setup_s=0.0, request_s=[host], wall_s=host, steps=program.steps, peak_bytes=0, spans={},
                      flops=cell.module.step_flops(cell.cfg, cell.traffic),
                      peaks=peaks.peaks(torch.cuda.get_device_name() if dev == "cuda" else "cpu"), trace=tr)
    metrics = {m["name"]: reader.read(run) for m, reader in cell.readers(True)}
    split = breakdown(run)
    attention = [s for s in spans if s.name == "attention" and s.attrs]
    return {"host_s": host, "window_s": tr.window_s, "busy_s": tr.busy_s, "spans": len(spans), "metrics": metrics,
            "breakdown": split, "split_check": split_check(metrics, split),
            "clock": clock_check(ctx.prof, spans),
            "route_attrs": sorted({tuple(sorted(s.attrs.items())) for s in attention}),
            "flash_bodies": {k: v for k, v in Profiler.instance().counters.items() if k.startswith("flash.body.")}}


def on_cost(program, pool, pairs, dev):
    """Request seconds (host clock to a synchronise, as ``image_s`` times
    them), tracing off and switched on, alternated; and the summary of the
    last request switched on."""
    from cfbench import timing
    from compactfusion_tpu_torch.utils.prof import Profiler

    order = []
    for i in range(pairs):
        order += ["off", "on"] if i % 2 == 0 else ["on", "off"]
    times, summary = {"off": [], "on": []}, None
    for k, mode in enumerate(order):
        Profiler.reset()
        Profiler.enable(mode == "on")
        timing.synchronize(dev)
        t = time.perf_counter()
        with Profiler.scope("total"):  # as ``RuntimeConfig.use_profiler`` runs a request (nothing when off)
            program.request(pool[(k + 2) % len(pool)], contextlib.nullcontext)
        timing.synchronize(dev)
        times[mode].append(time.perf_counter() - t)
        if mode == "on":
            summary = Profiler.summary()
        Profiler.enable(False)
        log(f"  {mode} {times[mode][-1]:.5f} s")
    med = {m: statistics.median(v) for m, v in times.items()}
    return {"order": order, "s": times, "median": med, "on_over_off": med["on"] / med["off"] - 1,
            "summary": summary}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", nargs="+", default=["flux-1024", "hunyuanvideo-544p-129f"])
    ap.add_argument("--pairs", type=int, default=3, help="off/on pairs of the on cost (one fewer for video)")
    ap.add_argument("--seed", type=int, default=2600000011)
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU at the CPU tests' sizes")
    args = ap.parse_args()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    from cfbench import harness

    dev = "cpu" if args.cpu else "cuda"
    smi = "cpu" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    report = {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(json.dumps(report))
    for i, name in enumerate(args.cells):
        t = time.perf_counter()
        cell, program, pool = build(name, args.seed + i, dev)
        log(f"{name} set-up {time.perf_counter() - t:.1f} s")
        rep = {"traced": traced(cell, program, pool, dev)}
        log(f"{name} traced: {json.dumps({k: v for k, v in rep['traced'].items() if k != 'breakdown'})}")
        log(f"{name} breakdown: {json.dumps(rep['traced']['breakdown'])}")
        rep["on_cost"] = on_cost(program, pool, args.pairs if "flux" in name else max(2, args.pairs - 1), dev)
        log(f"{name} on cost: {json.dumps({k: v for k, v in rep['on_cost'].items() if k != 'summary'})}")
        log(f"{name} summary of the last request switched on:\n{rep['on_cost']['summary']}")
        report[name] = rep
        del program, pool, cell
        gc.collect()
        harness.free_memory(dev)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    log("done")


if __name__ == "__main__":
    main()
