"""The joint attention's operations (4 B H Sq Sk d a call, from the shapes) over the bf16 peak
times the attention kernels' device time, in %."""

from cfbench import readers


def read(run):
    return readers.flash_roofline_pct(run)
