"""One ``torch.profiler`` window reduced to what the per-layer readers read.

Device work is every event of the kinds in :data:`DEVICE_WORK`; host work
the ``cpu_op`` events of the thread that ran most of them.  Times are the
trace's own clock; the window runs from its first event to its last, so
``busy_s`` and ``window_s`` come from one clock.  Kernels are classified by
name (:data:`CATEGORIES`, the first match wins): the port's flash kernels
(``flash_fwd_wgmma_kernel``, ``ring_flash_hop_wgmma_kernel``,
``flash_fwd_reg_kernel``, ``flash_fwd_wide_kernel`` ...) and any library
attention count as attention.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (
    ("attention", ("flash", "fmha", "attention")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "splitK", "gemv", "cublas")),
    ("conv", ("conv", "cudnn", "implicit_convolve")),
    ("copies", ("CatArray", "copy", "Memcpy", "Memset")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise", ("elementwise",)),
)
#: the categories of the backbone's matrix products and attention; the rest
#: is the elementwise, copy and reduction work around them
PRODUCTS = ("attention", "gemm", "conv")


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


@dataclasses.dataclass
class Trace:
    #: (name, start ns, duration ns, kind, correlation id) of the device work
    device: List[Tuple[str, int, int, str, int]]
    #: (name, start ns, duration ns) of the main thread's host operators
    host: List[Tuple[str, int, int]]
    #: correlation id -> start ns of the runtime call that launched it
    launches: Dict[int, int]
    t0: int
    t1: int
    #: denoising steps the window holds
    steps: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self):
        """The device's busy intervals, merged, in order."""
        out = []
        for s, d in sorted((s, d) for _, s, d, _, _ in self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s + d)
            else:
                out.append([s, s + d])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    @property
    def kernels(self) -> int:
        return sum(1 for ev in self.device if ev[3] == "kernel")

    def seconds_by_category(self) -> dict:
        out = collections.Counter()
        for name, _, d, _, _ in self.device:
            out[category(name)] += d / 1e9
        return dict(out)

    def device_ops(self, top=10):
        """The device operations that took most time: [[name, seconds], ...]."""
        out = collections.Counter()
        for name, _, d, _, _ in self.device:
            out[name[:200]] += d / 1e9
        return [[n, s] for n, s in out.most_common(top)]

    def idle_gaps(self, top=10):
        """Idle device time by what the host was doing: each gap is labelled
        by the innermost host operator that was running when the work after
        it was launched (at the window's end: when it closed)."""
        gaps, end = [], self.t0
        for name, s, d, _, corr in sorted(self.device, key=lambda ev: ev[1]):
            if s > end:
                gaps.append((s - end, self.launches.get(corr, s)))
            end = max(end, s + d)
        if self.t1 > end:
            gaps.append((self.t1 - end, self.t1))
        labels = _innermost(self.host, [q for _, q in gaps])
        out = collections.Counter()
        for (ns, _), label in zip(gaps, labels):
            out[label] += ns / 1e9
        return [[n, s] for n, s in out.most_common(top)]


def _innermost(ops, queries):
    """For each query time, the name of the innermost op (nested intervals of
    one thread) that contains it, else "no host operator"."""
    ops = sorted(ops, key=lambda o: (o[1], -o[2]))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out, stack, k = [None] * len(queries), [], 0
    for i in order:
        q = queries[i]
        while k < len(ops) and ops[k][1] <= q:
            while stack and stack[-1][1] <= ops[k][1]:
                stack.pop()
            stack.append((ops[k][0], ops[k][1] + ops[k][2]))
            k += 1
        while stack and stack[-1][1] <= q:
            stack.pop()
        out[i] = stack[-1][0] if stack else "no host operator"
    return out


def _kind(ev) -> str:
    """The event's kineto activity kind; where ``_KinetoEvent`` lacks
    ``activity_type`` (torch 2.11), worked out from its device and name."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).rsplit(".", 1)[-1].lower()
    name = ev.name()
    if ev.device_type() != DeviceType.CPU:
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    if getattr(ev, "is_user_annotation", lambda: False)():
        return "user_annotation"
    return "cpu_op"


def from_profiler(prof, steps: int) -> Trace:
    """The trace of a finished ``torch.profiler.profile``."""
    device, host, launches, threads = [], [], {}, collections.Counter()
    t0, t1 = None, None
    for ev in prof.profiler.kineto_results.events():
        kind, s, d = _kind(ev), ev.start_ns(), ev.duration_ns()
        t0 = s if t0 is None else min(t0, s)
        t1 = s + d if t1 is None else max(t1, s + d)
        if kind in DEVICE_WORK:
            device.append((ev.name(), s, d, kind, ev.correlation_id()))
        elif kind == "cpu_op":
            host.append((ev.name(), s, d, ev.start_thread_id()))
            threads[ev.start_thread_id()] += 1
        elif kind in ("cuda_runtime", "cuda_driver"):
            launches[ev.correlation_id()] = s
    main = threads.most_common(1)[0][0] if threads else None
    host = [(n, s, d) for n, s, d, th in host if th == main]
    return Trace(device=device, host=host, launches=launches, t0=t0 or 0, t1=t1 or 0, steps=steps)
