"""The one generator of request inputs: a traffic mix's parameters plus the
configuration's input shapes and the seed -> the pool of requests a run
sends, in the order it sends them.

A traffic file (``cfbench/traffic/<name>.json``) holds ``loop`` (only
``closed``: one client sends its next request when the last one is done),
``clients``, ``batch``, ``pool`` (distinct requests a run cycles through)
and what the configuration reads (``height``, ``width``, ``frames``,
``steps``, ``guidance``, ``shift``, ``text_tokens``, ``text_lengths``).
The configuration names each input with its shape and kind
(``input_shapes``): ``normal_fp32`` and ``normal_bf16`` are standard
normals, ``prefix_mask`` a boolean mask of the first ``n`` tokens with
``n`` from ``text_lengths``.  Every seed gets the same set of lengths, in
its own order, so every seed asks for the same work.
"""

from __future__ import annotations

import random

import torch

from cfbench.weights import sub_seed

LOOPS = ("closed",)
DTYPES = {"normal_fp32": torch.float32, "normal_bf16": torch.bfloat16}


def check(traffic: dict) -> None:
    if traffic.get("loop") not in LOOPS or traffic.get("clients") != 1:
        raise ValueError(f"traffic loop {traffic.get('loop')!r} with {traffic.get('clients')} clients: "
                         f"the generator runs {LOOPS} loops of one client")


def requests(traffic: dict, shapes: dict, seed: int, device) -> list:
    """``traffic["pool"]`` requests, each a dict of tensors on ``device``."""
    check(traffic)
    n = traffic["pool"]
    order = random.Random(sub_seed(seed, "traffic order"))
    lengths = list(traffic.get("text_lengths", ()))
    order.shuffle(lengths)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    pool = []
    for i in range(n):
        req = {}
        for name, (shape, kind) in shapes.items():
            if kind in DTYPES:
                req[name] = torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(DTYPES[kind])
            elif kind == "prefix_mask":
                b, s = shape
                valid = [lengths[(i * b + j) % len(lengths)] for j in range(b)]
                req[name] = torch.arange(s, device=device)[None, :] < torch.tensor(valid, device=device)[:, None]
            else:
                raise ValueError(f"input {name!r}: unknown kind {kind!r}")
        pool.append(req)
    return pool
