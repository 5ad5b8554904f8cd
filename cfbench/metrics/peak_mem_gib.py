"""Peak device memory over the window, torch.cuda.max_memory_allocated after a reset at its start,
in GiB."""

from cfbench import readers


def read(run):
    return readers.peak_gib(run)
