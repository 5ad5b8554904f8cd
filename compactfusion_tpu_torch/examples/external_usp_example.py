"""Plug the port's USP into YOUR OWN PyTorch model (counterpart of
``examples/external_usp_example.py``).

The reference ships a functional ``USP()`` for external projects that are
not diffusers pipelines (``xfuser/model_executor/layers/usp.py:137-158``).
Here it is :func:`compactfusion_tpu_torch.parallel.usp.usp_attention`: a
plain function over this rank's sequence shard and a mesh; no engine, no
registry, no wrapper classes.

This script builds a toy transformer block from scratch (not a bundled
model), shards its sequence over Ulysses x ring on 4 ranks, swaps plain
attention for ``usp_attention`` and checks the result against the same
block on one device (relative error below 2e-5).  On the GPU, with
``seq_len`` 1,024 or more, each ring hop's fp32 q/k/v go through the flash
kernel's fp32 route.

    torchrun --nproc_per_node 4 -m compactfusion_tpu_torch.examples.external_usp_example

(one GPU per rank, NCCL); ranks that share one card or the CPU call
:func:`main` inside ``parallel.mesh.spawn_local(..., "gloo")``.
"""

from __future__ import annotations

import numpy as np
import torch

from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, AXIS_ULYSSES, init_distributed_environment, make_mesh
from compactfusion_tpu_torch.parallel.usp import usp_attention
from compactfusion_tpu_torch.pipelines.base import slice_local_tokens

B, S, H, D = 1, 256, 8, 32
ULYSSES, RING = 2, 2
REL_MAX = 2e-5


class MyBlock(torch.nn.Module):
    """Your model's attention block: any code; only ``attn_fn`` is swapped."""

    def __init__(self, qkv: torch.Tensor, out: torch.Tensor, attn_fn):
        super().__init__()
        self.qkv = torch.nn.Parameter(qkv, requires_grad=False)
        self.out = torch.nn.Parameter(out, requires_grad=False)
        self.attn_fn = attn_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (x @ self.qkv).reshape(B, -1, H, 3 * D).split(D, dim=-1)
        o = self.attn_fn(q, k, v)
        return x + o.reshape(B, -1, H * D) @ self.out


def plain_attention(q, k, v):
    """Single-device reference: softmax attention on (B, S, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D**-0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def main(device=None, seq_len: int = S) -> float:
    """Run on this rank (4 ranks: torchrun's, or an initialised process
    group); ``device`` defaults to this rank's GPU.  ``seq_len`` tokens
    (the JAX example's 256 by default; from 1,024 a hop's 512 keys meet
    the flash kernel's routing contract).  Returns the relative error of
    the sharded block against the one-device block."""
    if device is None:
        device = init_distributed_environment("nccl", "cuda")
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((H * D, 3 * H * D)) * 0.05).float().to(device)
    out = torch.from_numpy(rng.standard_normal((H * D, H * D)) * 0.05).float().to(device)
    x = torch.from_numpy(rng.standard_normal((B, seq_len, H * D))).float().to(device)

    with torch.no_grad():
        ref = MyBlock(qkv, out, plain_attention)(x)

        # USP: the sequence sharded over (ring, ulysses); ONE line changes
        mesh = make_mesh(ParallelConfig(ulysses_degree=ULYSSES, ring_degree=RING))
        block = MyBlock(qkv, out, lambda q, k, v: usp_attention(q, k, v, mesh=mesh, ulysses_size=ULYSSES))
        local = block(slice_local_tokens(x, mesh, ULYSSES, RING, dim=1).contiguous())
        # rank r x U + u holds the (r U + u)-th shard: gather Ulysses, then ring
        full = torch.cat(mesh.all_gather(torch.cat(mesh.all_gather(local, AXIS_ULYSSES), dim=1), AXIS_RING), dim=1)

    err = float(torch.linalg.vector_norm(full - ref) / (torch.linalg.vector_norm(ref) + 1e-12))
    print(f"usp (ulysses={ULYSSES} x ring={RING}) vs single-device rel err: {err:.2e}")
    if not err < REL_MAX:
        raise AssertionError(f"external USP: rel err {err} >= {REL_MAX}")
    print("EXTERNAL USP OK")
    return err


if __name__ == "__main__":
    main()
