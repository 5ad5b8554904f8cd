"""Device ms a step of the kernels outside matrix products and attention launched inside the blocks'
``modulate`` spans (the AdaLN linear's bias and chunks, the layernorm, scale and shift, both
streams, before attention and before the FFN), from the profiled request's program spans."""

from cfbench import spans


def read(run):
    return spans.part_ms_per_step(run, ("modulate",))
