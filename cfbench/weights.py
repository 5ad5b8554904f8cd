"""Seeded inputs: sub-seeds and the weight trees, drawn on the device.

A tree's leaves share one flat buffer filled with standard normals by a
``torch.Generator`` on the device, a few large calls in all, then scaled in
place by their kind (``reference/layout.py::Leaf``).  The same seed on the
same device gives the same bits, so the reference can draw its own copy
after the program's is freed.
"""

from __future__ import annotations

import hashlib
import math

import torch

from cfbench.reference.layout import Leaf

#: elements drawn by one call, and the alignment of every leaf in the buffer
CHUNK = 2**28
ALIGN = 128
#: the configuration files' ``dtype`` names
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: standard deviations by kind (``conv_w``: 1 / sqrt(fan-in), worked out per leaf)
STD = {"w": 0.02, "b": 0.02, "mod_b": 0.5}


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose (weights, traffic, the check's sample)."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{what}".encode()).digest()[:8], "little") >> 1


def _leaves(tree):
    """The leaves in the order :func:`_build` visits them."""
    if isinstance(tree, Leaf):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


def _fill(view: torch.Tensor, leaf: Leaf) -> None:
    if leaf.kind in STD:
        view.mul_(STD[leaf.kind])
    elif leaf.kind == "conv_w":
        view.mul_(1.0 / math.sqrt(math.prod(leaf.shape[:-1])))
    elif leaf.kind == "one":
        view.fill_(1.0)
    elif leaf.kind == "zero":
        view.zero_()
    elif leaf.kind == "eye":
        view.zero_()
        view.view(-1, leaf.shape[-1]).fill_diagonal_(1.0)
    else:
        raise ValueError(f"unknown leaf kind {leaf.kind!r}")


def draw(layout, seed: int, device, dtype=torch.bfloat16):
    """The tree of ``layout`` with tensors of ``dtype`` on ``device``."""
    leaves = list(_leaves(layout))
    sizes = [-(-math.prod(leaf.shape) // ALIGN) * ALIGN for leaf in leaves]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, flat.numel(), CHUNK):
        flat[start:start + CHUNK].normal_(generator=g)
    views, offset = [], 0
    for leaf, size in zip(leaves, sizes):
        view = flat[offset:offset + math.prod(leaf.shape)].view(leaf.shape)
        _fill(view, leaf)
        views.append(view)
        offset += size
    return _build(layout, iter(views))


def _build(node, views):
    """``node``'s structure with its leaves taken from ``views`` in
    :func:`_leaves`' order (a plain function: a recursive closure would hold
    the buffer in a reference cycle until the collector ran)."""
    if isinstance(node, Leaf):
        return next(views)
    if isinstance(node, dict):
        return {k: _build(v, views) for k, v in node.items()}
    return [_build(v, views) for v in node]
