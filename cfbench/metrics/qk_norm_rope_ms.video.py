"""Device ms a step of the kernels outside matrix products and attention launched inside the blocks'
``qk_norm_rope`` spans (rmsnorm of q and k, and rope), from the profiled request's program spans."""

from cfbench import spans


def read(run):
    return spans.part_ms_per_step(run, ("qk_norm_rope",))
