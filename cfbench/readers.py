"""The arithmetic the metric readers (``cfbench/metrics/<metric>.py``) share.
Each takes a ``harness.Run`` and returns a number, or None where the run
has nothing to read (no trace, no device work, a card without peaks)."""

from __future__ import annotations

import statistics

from cfbench.trace import PRODUCTS


def seconds_per_request(run):
    return sum(run.request_s) / len(run.request_s) if run.request_s else None


def seconds_per_step(run):
    return run.wall_s / run.steps if run.steps else None


def peak_gib(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None


def span_median(run, name):
    return statistics.median(run.spans[name]) if run.spans.get(name) else None


def _trace(run):
    t = run.trace
    return t if t is not None and t.device and t.steps else None


def elementwise_ms_per_step(run):
    """Device ms a step in work other than matrix products and attention."""
    t = _trace(run)
    if t is None:
        return None
    return sum(s for cat, s in t.seconds_by_category().items() if cat not in PRODUCTS) / t.steps * 1e3


def flash_roofline_pct(run):
    """The joint attention's operations over (bf16 peak x the attention
    kernels' device time), in %."""
    t = _trace(run)
    att = t.seconds_by_category().get("attention", 0.0) if t else 0.0
    if not att or run.peaks is None:
        return None
    return 100.0 * run.flops["flash_attention"] * t.steps / (run.peaks["bf16_flops"] * att)


def step_mfu_pct(run):
    """The step's model operations over (bf16 peak x the traced window), in %."""
    t = _trace(run)
    if t is None or run.peaks is None:
        return None
    return 100.0 * run.flops["total"] * t.steps / (run.peaks["bf16_flops"] * t.window_s)


def device_idle_pct(run):
    t = _trace(run)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per_step(run):
    t = _trace(run)
    return None if t is None else t.kernels / t.steps
