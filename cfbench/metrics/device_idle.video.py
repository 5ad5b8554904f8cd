"""The share of the profiled window in which no device work ran, in %."""

from cfbench import readers


def read(run):
    return readers.device_idle_pct(run)
