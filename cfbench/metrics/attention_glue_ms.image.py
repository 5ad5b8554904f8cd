"""Device ms a step of the kernels outside matrix products and attention launched inside the blocks'
``attention`` spans other than the attention kernels (the joint concat, the split, casts), from the
profiled request's program spans."""

from cfbench import spans


def read(run):
    return spans.part_ms_per_step(run, ("attention",))
