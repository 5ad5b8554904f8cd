"""One run of one cell: set-up, the measured window, the check, the metrics.

``run.py`` is the command; this module holds what it does once it has a
card, so the tests can drive a run on the CPU at small sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from cfbench import check, peaks, timing, traffic as traffic_gen
from cfbench.reference.precision import Precision, fp32_matmuls
from cfbench.trace import Trace, from_profiler
from cfbench.weights import sub_seed

#: top-level modules no run may hold: JAX and the JAX package (compared whole:
#: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "compactfusion_tpu")


def forbidden_modules(modules=None) -> List[str]:
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float
    #: host seconds of each request of the window, each ended by a synchronise
    request_s: List[float]
    #: the window's wall time, from its start to the end of its last request
    wall_s: float
    #: denoising steps the window completed
    steps: int
    peak_bytes: int
    #: seconds of each named span of the unprofiled requests
    spans: Dict[str, List[float]]
    #: operations of one denoising step (``cfbench/flops.py``)
    flops: dict
    #: the card's peaks (``peaks.py``), None where unknown
    peaks: Optional[dict]
    trace: Optional[Trace] = None


class _StepProfile:
    """The context ``Program.request`` puts around a request's steps: a
    ``torch.profiler`` window that ends with a synchronise."""

    def __init__(self, device):
        self.device, self.prof = device, None

    @contextlib.contextmanager
    def __call__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(self.device).type == "cuda" else [])
        with profile(activities=acts) as prof:
            yield
            timing.synchronize(self.device)
        self.prof = prof


def _peak_reset(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


class _GcPauses:
    """Seconds the cyclic garbage collector ran, for the log."""

    def __init__(self):
        self.total, self._t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t


def window(program, pool, seconds: float, device, profile: bool, log):
    """Closed loop, one client: requests back to back from the pool until
    ``seconds`` have passed (in a traced run at least two, the second one
    profiled).  -> (outputs, request seconds, wall seconds, spans, trace,
    peak bytes).  The log gives each request's host CPU seconds and the
    collector's pauses beside its time, which tells a host that was held
    up from a card that ran slow."""
    outs, times, spans, trace = [], [], {}, None
    gc_pauses = _GcPauses()
    gc.callbacks.append(gc_pauses)
    timing.synchronize(device)
    _peak_reset(device)
    try:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or (profile and len(times) < 2):
            profiled = profile and len(times) == 1
            ctx = _StepProfile(device) if profiled else contextlib.nullcontext
            t, cpu, paused = time.perf_counter(), time.process_time(), gc_pauses.total
            out, sp = program.request(pool[len(times) % len(pool)], ctx)
            timing.synchronize(device)
            times.append(time.perf_counter() - t)
            outs.append(out)
            if profiled:
                trace = from_profiler(ctx.prof, program.steps)
            else:
                for name, span in sp.items():
                    spans.setdefault(name, []).append(span.seconds())
            log(f"request {len(times) - 1}: {times[-1]:.4f} s{' (profiled)' if profiled else ''} (host cpu "
                f"{time.process_time() - cpu:.4f} s, gc {gc_pauses.total - paused:.4f} s)")
        wall = time.perf_counter() - start
    finally:
        gc.callbacks.remove(gc_pauses)
    return outs, times, wall, spans, trace, _peak(device)


def free_memory(device):
    """Collect what is unreferenced and hand the cached blocks back to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float, log=None) -> dict:
    """Set-up from the seed, the window, then the check of one request of it
    drawn from the seed against the reference; -> the result's keys."""
    log = log or (lambda msg: print(f"[cfbench {cell.name}] {msg}", file=sys.stderr, flush=True))
    mod, cfg, traffic = cell.module, cell.cfg, cell.traffic
    shapes = mod.input_shapes(cfg, traffic)
    params = mod.build(cfg, seed, device)
    pool = traffic_gen.requests(traffic, shapes, seed, device)
    program = mod.Program(cfg, traffic, params, device)
    program.warm_up(pool[0])
    timing.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    outs, times, wall, spans, tr, peak = window(program, pool, seconds, device, trace, log)
    name = torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"
    run = Run(setup_s=setup_s, request_s=times, wall_s=wall, steps=len(times) * program.steps,
              peak_bytes=peak, spans=spans,
              flops=mod.step_flops(cfg, traffic), peaks=peaks.peaks(name), trace=tr)

    # the check: one request of the window, drawn from the seed, against the
    # reference run on weights and inputs it draws again from the seed
    j = random.Random(sub_seed(seed, "check")).randrange(len(outs))
    judged = outs[j]
    del program, params, pool, outs
    free_memory(device)
    fp32_matmuls()
    ref_params = mod.build(cfg, seed, device)
    ref_req = traffic_gen.requests(traffic, shapes, seed, device)[j % traffic["pool"]]
    t_ref = time.perf_counter()
    with torch.inference_mode():
        ref_out = mod.reference(cfg, traffic, ref_params, ref_req, Precision("fp32"))
    timing.synchronize(device)
    log(f"reference of request {j}: {time.perf_counter() - t_ref:.1f} s")
    correct, table = check.judge(judged, ref_out, cell.limits)
    del ref_params, ref_out
    free_memory(device)

    metrics = {}
    for entry, reader in cell.readers(trace):
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if name != "cpu" else "cpu", "kind": name, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(times), "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    log(f"requests {len(times)}, median {statistics.median(times):.4f} s, window {wall:.3f} s, "
        f"peak {peak / 2**30:.3f} GiB")
    result["checks"] = table
    return result
