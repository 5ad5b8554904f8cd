"""The program's spans joined to the profiled window's trace.

The port records its spans in memory while a ``torch.profiler`` session
records (``compactfusion_tpu_torch/utils/prof.py``), stamped with
``time.time_ns()``, the clock of the trace's own events; they add no event to
the trace.  Each device event goes under the innermost span that holds its
launch (the runtime call's start, ``Trace.launches``; an event with none under
its own start), and each idle gap under the innermost span that holds the
launch of the work after it, the rule ``Trace.idle_gaps`` applies to host
operators.  The window's steps are its ``step`` spans.

Against a program that keeps no spans (one older than its tracer), every
function here returns None.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from cfbench.trace import PRODUCTS, Trace, category

#: the block families, whose leaf spans are a block's parts
FAMILIES = ("double_blocks", "single_blocks")


def program_spans() -> Optional[list]:
    """The program's closed spans, or None where it keeps none."""
    try:
        from compactfusion_tpu_torch.utils.prof import Profiler
    except ImportError:
        return None
    return Profiler.spans() if hasattr(Profiler, "spans") else None


@dataclasses.dataclass
class Joined:
    trace: Trace
    #: the spans that overlap the window
    spans: list
    steps: int
    #: per device event of ``trace.device``: the names of the spans that hold
    #: its launch, innermost first (empty where none does)
    chains: List[Tuple[str, ...]]
    #: (idle ns, the chain of the span that launched the work after the gap)
    gaps: List[Tuple[int, Tuple[str, ...]]]


def innermost(spans, queries) -> list:
    """For each query time, the innermost of ``spans`` (nested intervals
    [start_ns, end_ns) of one thread) that holds it, else None."""
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out, stack, k = [None] * len(queries), [], 0
    for i in sorted(range(len(queries)), key=queries.__getitem__):
        q = queries[i]
        while k < len(order) and order[k].start_ns <= q:
            while stack and stack[-1].end_ns <= order[k].start_ns:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1].end_ns <= q:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def join(trace: Trace, spans) -> Optional[Joined]:
    """The trace's device events and idle gaps under the spans; None without
    a ``step`` span in the window."""
    spans = [s for s in spans if s.end_ns > trace.t0 and s.start_ns < trace.t1]
    steps = sum(1 for s in spans if s.name == "step")
    if not steps:
        return None
    by_id = {s.id: s for s in spans}
    names: Dict[int, Tuple[str, ...]] = {}

    def chain(span):
        if span is None:
            return ()
        if span.id not in names:
            parent = by_id.get(span.parent)
            names[span.id] = (span.name,) + chain(parent)
        return names[span.id]

    launch = [trace.launches.get(corr, s) for _, s, _, _, corr in trace.device]
    chains = [chain(sp) for sp in innermost(spans, launch)]
    gaps, end = [], trace.t0
    for (_, s, d, _, corr) in sorted(trace.device, key=lambda ev: ev[1]):
        if s > end:
            gaps.append((s - end, trace.launches.get(corr, s)))
        end = max(end, s + d)
    if trace.t1 > end:
        gaps.append((trace.t1 - end, trace.t1))
    gap_spans = innermost(spans, [q for _, q in gaps])
    return Joined(trace=trace, spans=spans, steps=steps, chains=chains,
                  gaps=[(ns, chain(sp)) for (ns, _), sp in zip(gaps, gap_spans)])


_last: list = [None, None]


def joined(run) -> Optional[Joined]:
    """:func:`join` of the run's trace and the program's spans (computed
    once per trace)."""
    if run.trace is None or not run.trace.device:
        return None
    if _last[0] is not run.trace:
        spans = program_spans()
        _last[:] = [run.trace, None if spans is None else join(run.trace, spans)]
    return _last[1]


def part_ms_per_step(run, parts) -> Optional[float]:
    """Device ms a step of the kernels outside matrix products and
    attention (``cfbench/trace.py``'s ``PRODUCTS``) launched inside a span
    named in ``parts``."""
    j = joined(run)
    if j is None:
        return None
    ns = sum(d for (name, _, d, _, _), ch in zip(j.trace.device, j.chains)
             if category(name) not in PRODUCTS and any(p in ch for p in parts))
    return ns / j.steps / 1e6


def block_idle_ms_per_step(run) -> Optional[float]:
    """Idle device ms a step whose next work was launched inside a block
    family's span."""
    j = joined(run)
    if j is None:
        return None
    return sum(ns for ns, ch in j.gaps if any(f in ch for f in FAMILIES)) / j.steps / 1e6

