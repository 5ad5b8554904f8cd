"""Spans the benchmark puts around calls into the program."""

from __future__ import annotations

import time

import torch


class Span:
    """Device time between :meth:`start` and :meth:`stop` by CUDA events
    (no synchronisation), or host time on the CPU; :meth:`seconds` once
    the device has finished."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.cuda:
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.events[1].record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            return self.events[0].elapsed_time(self.events[1]) / 1e3
        return self.t1 - self.t0


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
