"""Activation collector: dump named tensors per (rank, step, layer) to disk
(counterpart of ``compactfusion_tpu/utils/collector.py``).

Reference semantics: ``Collector.collect`` (``xfuser/collector/
collector.py``): taps in the attention layer and the compact cache dump
q/k/v/kbase/vbase/latents for offline analysis.  Set ``CFTPU_COLLECT_DIR``
to enable it; it is read at every call, so collection can be switched on
and off within one process, and every call is a no-op while it is unset.

Two addressing modes, the file names of the JAX package:

  * explicit ``(step, layer)``: ``{dir}/{name}_s{step}_l{layer}_r{rank}.npy``;
  * auto-sequence (both omitted): ``{dir}/{name}_n{seq:05d}_r{rank}.npy``,
    ``seq`` a counter per (name, rank) in call order, which is the stream
    order here (``seq = step * n_layers + layer`` for a tap in every layer).

``rank`` defaults to this process's ``torch.distributed`` rank (0 without
a process group), as the JAX package defaults to the process index.  A
bf16 tensor is written as float32 (numpy has no bf16; every bf16 value is
exactly a float32 one); other dtypes as they are.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from compactfusion_tpu_torch import envs

_SEQ: dict = {}


def _dir() -> str:
    return envs.CFTPU_COLLECT_DIR


def enabled() -> bool:
    return bool(_dir())


def _default_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def collect(x: torch.Tensor, name: str, step: Optional[int] = None, layer: Optional[int] = None,
            rank: Optional[int] = None) -> None:
    """Dump ``x`` under ``name`` (see the module note for the file names)."""
    out_dir = _dir()
    if not out_dir:
        return
    rank = _default_rank() if rank is None else int(rank)
    os.makedirs(out_dir, exist_ok=True)
    if step is None and layer is None:
        seq = _SEQ.get((name, rank), 0)
        _SEQ[(name, rank)] = seq + 1
        path = os.path.join(out_dir, f"{name}_n{seq:05d}_r{rank}.npy")
    else:
        path = os.path.join(out_dir, f"{name}_s{int(step)}_l{int(layer)}_r{rank}.npy")
    np.save(path, _host(x))
