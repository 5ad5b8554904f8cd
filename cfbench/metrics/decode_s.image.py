"""Seconds of the VAE decode of an image request, CUDA events around FluxPipeline.decode; the
median of the window's unprofiled requests."""

from cfbench import readers


def read(run):
    return readers.span_median(run, "decode_s")
