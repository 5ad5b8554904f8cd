"""The port's tracer: spans and counters (counterpart of
``compactfusion_tpu/utils/prof.py``).

:class:`Profiler` is one singleton with two tables.

* **Spans** mark the layers of a request (``request`` ⊃ ``step`` ⊃ a block
  family ⊃ a block's parts; ``PERF.md`` lists the names).  A span is
  recorded while tracing is on: when the profiler was switched on
  (:meth:`Profiler.enable`: ``RuntimeConfig.use_profiler``, the examples)
  or while a ``torch.profiler`` session records, so whoever profiles the
  program gets its spans with no switch.  Spans are stamped with
  ``time.time_ns()``, the clock of the profiler's own events, and kept in
  memory in a ring of :data:`MAX_SPANS`; they add no event to the
  profiler's trace (no ``record_function``, no NVTX range) and never
  synchronise the device.  Switched on outside a profiler session, each
  span also records a CUDA event pair, read as device time once the device
  is drained (at a scope's exit, or by :meth:`Profiler.span_table`).  With
  tracing off a span site costs one check and allocates nothing.
  A **scope** is a span that times a whole request on the host, with the
  device drained at entry and exit (``sync``), as the reference's
  ``xfuser/prof.py`` does.
* **Counters** (launches of each kernel wrapper and tile body, bytes of
  each collective) count whether tracing is on or not.

:meth:`Profiler.summary` prints both: the spans of the last tree closed,
each name with its count, host and device ms and attributes, and the
counters.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: spans kept; older ones are dropped first (one FLUX.1 request at 28 steps
#: opens ~9,300, a HunyuanVideo step ~350)
MAX_SPANS = 1 << 16


class Span:
    """One span: ``name``, ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock, its ``id``, its ``parent``'s id and its ``request`` span's id
    (None outside any), ``attrs`` (a dict, or None where it has none), and
    of an explicit profile the CUDA event pair until it is read, then its
    ``device_ms`` (else None)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request", "attrs", "events", "device_ms")

    def __init__(self, name, span_id, parent, request, attrs):
        self.name, self.id, self.parent, self.request, self.attrs = name, span_id, parent, request, attrs
        self.events = self.device_ms = None

    def __enter__(self):
        prof = Profiler._instance
        prof._stack().append(self)
        if prof.enabled and not _autograd_profiler._is_profiler_enabled and _cuda_ready():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        prof = Profiler._instance
        prof._stack().pop()
        prof._spans.append(self)
        return False


class _Off:
    """The span of a site while tracing is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Profiler:
    #: the one tracer of the process, made at import
    _instance: "Profiler"

    def __init__(self):
        #: switched on explicitly (spans with device time, scopes that drain)
        self.enabled = False
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._spans = collections.deque(maxlen=MAX_SPANS)
        self._ids = itertools.count(1)
        self._local = threading.local()

    @classmethod
    def instance(cls) -> "Profiler":
        return cls._instance

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _read_events(self):
        """Turn the event pairs of the spans kept into ``device_ms`` (the
        device has been drained since they closed)."""
        for s in self._spans:
            if s.events is not None:
                s.device_ms, s.events = s.events[0].elapsed_time(s.events[1]), None

    @classmethod
    def enable(cls, on: bool = True):
        """Switch recording on (or off) outside any profiler session."""
        cls.instance().enabled = on

    @classmethod
    def spans(cls) -> List[Span]:
        """The closed spans kept, in the order they closed."""
        return list(cls.instance()._spans)

    @classmethod
    def window(cls) -> List[Span]:
        """The spans kept of the last tree closed: the last span to close
        (a request's ``total`` scope under ``use_profiler``, an example's
        ``total``, or a pipeline's ``request`` called alone: run a request
        and its decode in one scope to read both) and every span under it,
        in the order they closed."""
        spans = cls.spans()
        if not spans:
            return []
        tree = {spans[-1].id}
        for s in sorted(spans, key=lambda s: s.id):  # a parent opens before its children
            if s.parent in tree:
                tree.add(s.id)
        return [s for s in spans if s.id in tree]

    @classmethod
    def counter(cls, name: str) -> int:
        return cls.instance().counters.get(name, 0)

    @classmethod
    @contextlib.contextmanager
    def scope(cls, name: str, sync: bool = True):
        """A span of ``name`` around the block.  Switched on, with ``sync``,
        the device is drained at entry and, inside the span, at exit, so
        queued kernels are charged to the scope that launched them, and the
        device times of the spans closed so far are read."""
        self = cls.instance()
        fence = sync and self.enabled
        if fence:
            _device_fence()
        with span(name):
            try:
                yield
            finally:
                if fence:
                    _device_fence()
                    self._read_events()

    @classmethod
    def span_table(cls, spans: Optional[List[Span]] = None) -> Dict[str, dict]:
        """{span name: count, host ms, device ms, self device ms, attrs} of
        ``spans`` (default: :meth:`window`): the device columns from their
        CUDA events (None where a span has none; the device is drained
        first), ``attrs`` each attribute's distinct values in order."""
        self = cls.instance()
        if any(s.events is not None for s in self._spans):
            _device_fence()
            self._read_events()
        spans = cls.window() if spans is None else spans
        children = collections.defaultdict(float)
        for s in spans:
            if s.device_ms is not None and s.parent is not None:
                children[s.parent] += s.device_ms
        out: Dict[str, dict] = {}
        for s in spans:
            row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "device_ms": None, "self_device_ms": None,
                                          "attrs": {}})
            row["count"] += 1
            row["host_ms"] += (s.end_ns - s.start_ns) / 1e6
            if s.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
                row["self_device_ms"] = (row["self_device_ms"] or 0.0) + s.device_ms - children[s.id]
            for key, value in (s.attrs or {}).items():
                seen = row["attrs"].setdefault(key, [])
                if value not in seen:
                    seen.append(value)
        return out

    @classmethod
    def summary(cls, total_scope: str = "total") -> str:
        """The spans of :meth:`window`: each name with its count, host ms,
        share of the ``total_scope`` span's host ms, device ms, self device
        ms and distinct attributes; then the counters."""
        window = cls.window()
        lines = []
        if window:
            table = cls.span_table(window)
            requests = len({s.request for s in window if s.request is not None})
            total = table.get(total_scope, {}).get("host_ms")
            lines.append(f"spans of the last {window[-1].name} ({requests} request(s))")
            lines.append("span                          count    host(ms)      %  device(ms)    self(ms)")

            def ms(v):
                return f"{v:11.3f}" if v is not None else "          -"

            for name, row in sorted(table.items(), key=lambda kv: -(kv[1]["device_ms"] or kv[1]["host_ms"])):
                pct = f"{100.0 * row['host_ms'] / total:6.1f}" if total else "     -"
                lines.append(f"{name:28s} {row['count']:6d} {row['host_ms']:11.3f} {pct} {ms(row['device_ms'])} "
                             f"{ms(row['self_device_ms'])}")
                for key, values in row["attrs"].items():
                    shown = ", ".join(map(str, values[:8])) + (f", ... ({len(values)} values)"
                                                               if len(values) > 8 else "")
                    lines.append(f"    {key}: {shown}")
        counters = sorted((k, v) for k, v in cls.instance().counters.items() if v)
        if counters:
            lines.append("counter (since Profiler.reset())                       value")
            lines += [f"{k:52s} {v:8d}" for k, v in counters]
        return "\n".join(lines)

    @classmethod
    def reset(cls):
        """Clear the spans and zero the counters."""
        self = cls.instance()
        self.counters.clear()
        self._spans.clear()


Profiler._instance = Profiler()


def tracing() -> bool:
    """Whether spans are recorded now: switched on, or a profiler session records."""
    return Profiler._instance.enabled or _autograd_profiler._is_profiler_enabled


def span(name: str, attrs: Optional[dict] = None):
    """A context that records a span of ``name`` while tracing is on (else a
    shared no-op); ``attrs`` are the span's attributes."""
    prof = Profiler._instance
    if not (prof.enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    stack = prof._stack()
    parent = stack[-1] if stack else None
    span_id = next(prof._ids)
    request = span_id if name == "request" else (parent.request if parent is not None else None)
    return Span(name, span_id, parent.id if parent is not None else None, request, attrs)


def annotate(attrs: dict):
    """Add ``attrs`` to the innermost open span (nothing while none is open)."""
    stack = Profiler._instance._stack()
    if stack:
        stack[-1].attrs = {**(stack[-1].attrs or {}), **attrs}


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    Profiler._instance.counters[name] += n


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _device_fence():
    """Wait for every kernel queued on the current CUDA device (nothing to
    wait for without one)."""
    if _cuda_ready():
        torch.cuda.synchronize()
