"""Named-scope profiler (counterpart of ``compactfusion_tpu/utils/prof.py``).

Reference semantics (``xfuser/prof.py``): a singleton accumulating elapsed
time per name, with a decorator, a context manager and a summary sorted by
total time with the share of a ``total`` scope.  Scopes measure host wall
time; with ``sync`` the device is drained (``torch.cuda.synchronize`` on
the bound device) at scope entry and exit, so queued kernels are charged to
the scope that launched them.  :meth:`Profiler.trace` wraps
``torch.profiler`` for op-level device times.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Profiler:
    _instance: Optional["Profiler"] = None

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @classmethod
    def instance(cls) -> "Profiler":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    @contextlib.contextmanager
    def scope(cls, name: str, sync: bool = True):
        self = cls.instance()
        if not self.enabled:
            yield
            return
        if sync:
            _device_fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _device_fence()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @classmethod
    def prof_func(cls, name: Optional[str] = None):
        def deco(fn):
            scope_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with cls.scope(scope_name):
                    return fn(*a, **kw)

            return wrapped

        return deco

    @classmethod
    @contextlib.contextmanager
    def trace(cls, log_dir: str):
        """An op-level trace of the scope by ``torch.profiler`` (CPU and,
        where a GPU is visible, CUDA activity), written to ``log_dir`` as a
        Chrome trace; yields the profiler."""
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=acts) as prof:
            yield prof
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    @classmethod
    def summary(cls, total_scope: str = "total") -> str:
        """Per-scope breakdown sorted by total time."""
        self = cls.instance()
        total = self.totals.get(total_scope, None)
        lines = ["name                                     total(s)   count     %"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = f"{100.0 * t / total:5.1f}" if total else "    -"
            lines.append(f"{name:40s} {t:8.3f} {self.counts[name]:7d} {pct}")
        return "\n".join(lines)

    @classmethod
    def reset(cls):
        self = cls.instance()
        self.totals.clear()
        self.counts.clear()


def _device_fence():
    """Wait for every kernel queued on the current CUDA device (nothing to
    wait for without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
