"""Seconds from the process's start to the end of the warm-up: import, kernel build or load,
weights, requests, warm-up."""


def read(run):
    return run.setup_s
