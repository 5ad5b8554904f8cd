"""Device time without dispatch cost, for the profiling probes.

The GPU counterpart of the JAX probes' device-side ``fori_loop`` and their
``(t(N_HI) - t(N_LO)) / (N_HI - N_LO)`` (``_prof2_dbg.py:199-224``,
``_prof_kernel_parts.py:135-147``):

* :func:`per_call_ms` captures one CUDA graph of ``n_lo`` calls and one of
  ``n_hi`` calls, replays each between CUDA events, and divides the
  difference of the two times by ``n_hi - n_lo``.  Inside a graph the
  kernels run back to back with no host launch between them, and what a
  replay costs once cancels in the difference.
* :func:`per_forward_ms` captures one graph of one call and times ``n_lo``
  and ``n_hi`` replays of it, then the same counts of eager calls, whose
  difference keeps the host's launch gaps: the two side by side show what
  dispatch costs.

Each time is the minimum over ``REPS`` repetitions, as in the JAX scripts.
A wrapper counts a launch when a graph is captured, not when it is
replayed, so each function also returns the launches the device ran:
``{wrapper name: count}`` over the ``kernels`` it is given.

A kernel timed again and again on the same inputs reads them from the L2
cache, where its last call left them (the H100's holds 50 MB), and can
then beat a bound that counts DRAM bytes.  :func:`copies` says how many
sets of inputs a timed call cycles through (:func:`rotate`) so that each
call finds its inputs in DRAM and writes where no recent call wrote.
Everything here needs a CUDA device and raises without one.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

from compactfusion_tpu_torch.utils.prof import Profiler

REPS = 3


def require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the GPU and needs a CUDA device; none is available")


def copies(nbytes: int) -> int:
    """How many sets of ``nbytes`` (a call's inputs and outputs) together
    fill four times the L2 cache of the current device."""
    require_cuda("copies")
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    return max(2, math.ceil(4 * l2 / nbytes))


def rotate(calls: Sequence[Callable[[], object]]) -> Callable[[], object]:
    """One call that runs ``calls`` in turn, one per call.  Each result is
    kept until its call runs again, so the outputs take turns in memory as
    the inputs do."""
    kept = [None] * len(calls)
    turn = itertools.cycle(range(len(calls)))

    def call():
        i = next(turn)
        kept[i] = calls[i]()
        return kept[i]

    return call


def counts(kernels) -> Dict[str, int]:
    """{wrapper name: its launch count} of the kernels' wrappers."""
    return {fn.__name__: Profiler.counter(f"{fn.__name__}.launches") for fn in kernels}


def capture(fn: Callable[[], object], n: int, kernels: Iterable = ()) -> Tuple[torch.cuda.CUDAGraph, Dict[str, int]]:
    """A CUDA graph of ``n`` calls of ``fn``, after one eager call on a side
    stream (which builds and loads what ``fn`` needs first); returns the
    graph and the launches counted during the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = counts(kernels)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph, {k: c - before[k] for k, c in counts(kernels).items()}


def min_ms(run: Callable[[], object]) -> float:
    """The least time of ``REPS`` runs of ``run`` between CUDA events (ms)."""
    best = float("inf")
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _ran(kernels, before, graphs) -> Dict[str, int]:
    """Launches the device ran: what the wrappers counted since ``before``,
    with each capture's count ``(per capture, replays)`` taken per replay."""
    after = counts(kernels)
    return {k: after[k] - before[k] + sum(per[k] * (replays - 1) for per, replays in graphs)
            for k in after}


def per_call_ms(fn, n_lo: int, n_hi: int, kernels: Iterable = ()):
    """(ms per call of ``fn`` with no dispatch cost, launches run)."""
    require_cuda("per_call_ms")
    kernels = tuple(kernels)
    before = counts(kernels)
    times, graphs = {}, []
    for n in (n_lo, n_hi):
        graph, per = capture(fn, n, kernels)
        times[n] = min_ms(graph.replay)
        graphs.append((per, REPS))
        del graph
    return (times[n_hi] - times[n_lo]) / (n_hi - n_lo), _ran(kernels, before, graphs)


def per_forward_ms(fn, n_lo: int, n_hi: int, kernels: Iterable = ()):
    """({"replay_ms", "eager_ms"} per call of ``fn``, launches run): one
    graph of one call replayed ``n_lo`` and ``n_hi`` times, and the same
    counts of eager calls."""
    require_cuda("per_forward_ms")
    kernels = tuple(kernels)
    before = counts(kernels)
    graph, per = capture(fn, 1, kernels)

    def replays(n):
        return lambda: [graph.replay() for _ in range(n)]

    def eager(n):
        return lambda: [fn() for _ in range(n)]

    span = n_hi - n_lo
    out = {"replay_ms": (min_ms(replays(n_hi)) - min_ms(replays(n_lo))) / span,
           "eager_ms": (min_ms(eager(n_hi)) - min_ms(eager(n_lo))) / span}
    ran = _ran(kernels, before, [(per, REPS * (n_lo + n_hi))])
    del graph
    return out, ran
