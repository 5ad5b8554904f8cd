"""The comparison that decides ``correct``.

A cell's limits file (``cfbench/workloads/<cell>.json``) names each number
compared with its limit.  ``<output>_rel`` is the relative Frobenius error
of the program's output ``<output>`` against the reference's,
||program - reference|| / ||reference|| in float64.  A number that is not
finite fails.
"""

from __future__ import annotations

import math

import torch


def rel_fro(program: torch.Tensor, reference: torch.Tensor) -> float:
    p, r = program.double(), reference.to(program.device).double()
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))


def numbers(program: dict, reference: dict, names) -> dict:
    out = {}
    for name in names:
        if not name.endswith("_rel"):
            raise ValueError(f"compared number {name!r}: only <output>_rel")
        key = name[: -len("_rel")]
        out[name] = rel_fro(program[key], reference[key])
    return out


def judge(program: dict, reference: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}})."""
    got = numbers(program, reference, limits)
    table = {name: {"value": got[name], "limit": limits[name]} for name in limits}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return correct, table
