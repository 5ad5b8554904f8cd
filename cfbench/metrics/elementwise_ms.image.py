"""Device ms a denoising step spends outside matrix products and attention (elementwise, copies,
casts, reductions), from the profiled request."""

from cfbench import readers


def read(run):
    return readers.elementwise_ms_per_step(run)
