"""Kernel launches a denoising step, from the profiled request."""

from cfbench import readers


def read(run):
    return readers.launches_per_step(run)
