"""A step's model operations (cfbench/flops.py) over the bf16 peak times the profiled window, in %."""

from cfbench import readers


def read(run):
    return readers.step_mfu_pct(run)
