"""Seconds per denoising step: the window's wall time over the steps its requests completed."""

from cfbench import readers


def read(run):
    return readers.seconds_per_step(run)
