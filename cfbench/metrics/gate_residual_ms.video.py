"""Device ms a step of the kernels outside matrix products and attention launched inside the blocks'
``out_gate`` and ``ffn_gate`` spans (the output projection's and the FFN's gate and residual, the
FFN's activation; in single blocks the whole ``out_proj``), from the profiled request's program
spans."""

from cfbench import spans


def read(run):
    return spans.part_ms_per_step(run, ("out_gate", "ffn_gate"))
