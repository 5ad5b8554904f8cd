"""Idle device ms a step whose next work was launched inside the double or single blocks' spans, from
the profiled request's program spans."""

from cfbench import spans


def read(run):
    return spans.block_idle_ms_per_step(run)
