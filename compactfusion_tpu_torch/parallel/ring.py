"""Ring attention across ranks (counterpart of ``compactfusion_tpu/parallel/ring.py``).

K/V blocks circulate around the ring group; each rank computes an attention
partial against every block and merges them with the online-softmax rule.
Joint (text) K/V replicated on every rank join the block at step 0
("front") or at the last step ("rear").

:func:`ring_shift` is the transport of every ring in the port, compressed
or not: a two-sided exchange (``dist.batch_isend_irecv``) on the ring group,
which orders itself, so no fence is needed.  The JAX package's
``lax.ppermute`` becomes this; its fused kernels' in-kernel RDMA becomes
this exchange between one kernel launch per hop (``ops/ring_flash.py``).
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.distributed as dist

from compactfusion_tpu_torch.ops.attention import attn_with_lse
from compactfusion_tpu_torch.ops.merge import merge_out_lse
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, Mesh, pack_tree
from compactfusion_tpu_torch.utils.prof import count


def ring_shift(tree, mesh: Mesh, axis: str = AXIS_RING, async_op: bool = False):
    """Send a tensor tree (a tuple, a NamedTuple payload) to the next rank
    of ``axis`` and receive the previous rank's tree of the same structure,
    shapes and dtypes.

    The leaves travel as one byte buffer (``parallel.mesh.pack_tree``):
    the bytes on the wire are exactly the leaves' bytes
    (``codecs.payload_nbytes``).  Under NCCL the buffer is sent where it
    lies; under gloo a CUDA buffer goes through a host copy.
    ``async_op``: start the exchange and return a ``wait()`` that finishes
    it and returns the received tree, so a hop's compute can run in
    between.  The counter ``ring_shift.nbytes`` counts the bytes sent."""
    if mesh.axis_size(axis) == 1:
        return (lambda: tree) if async_op else tree
    flat, unpack = pack_tree(tree)
    buf = mesh.wire(flat)
    recv = torch.empty_like(buf)
    group = mesh.groups[axis]
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, mesh.peer(axis, +1), group=group),
        dist.P2POp(dist.irecv, recv, mesh.peer(axis, -1), group=group),
    ])
    count("ring_shift.nbytes", buf.numel())

    def wait():
        for w in works:
            w.wait()
        return unpack(recv)

    return wait if async_op else wait()


def ring_blocks(tree, mesh: Optional[Mesh], axis: str = AXIS_RING) -> Iterator:
    """The blocks a rank works on, hop by hop: its own ``tree`` at hop 0,
    then at hop s the tree of rank (my - s) % R.  The exchange for hop s + 1
    starts before hop s is handed out, so it runs while the caller computes
    on hop s."""
    ring_size = 1 if mesh is None else mesh.axis_size(axis)
    cur = tree
    for step in range(ring_size):
        wait = ring_shift(cur, mesh, axis, async_op=True) if step < ring_size - 1 else None
        yield cur
        if wait is not None:
            cur = wait()


def with_joint(k, v, joint_k, joint_v, joint_strategy: str, step: int, ring_size: int):
    if joint_k is None or joint_strategy == "none":
        return k, v
    if joint_strategy == "front" and step == 0:
        return torch.cat([joint_k, k], dim=1), torch.cat([joint_v, v], dim=1)
    if joint_strategy == "rear" and step == ring_size - 1:
        return torch.cat([k, joint_k], dim=1), torch.cat([v, joint_v], dim=1)
    return k, v


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Optional[Mesh],
    axis: str = AXIS_RING,
    scale: Optional[float] = None,
    causal: bool = False,
    joint_k: Optional[torch.Tensor] = None,
    joint_v: Optional[torch.Tensor] = None,
    joint_strategy: str = "none",
    fused: bool = False,
) -> torch.Tensor:
    """Exact attention over the ring-sharded K/V sequence.

    q (B, Sq_local, H, D); k, v (B, Sk_local, H, D), this rank's shard;
    joint_k/joint_v (B, Sj, H, D) replicated, appended per
    ``joint_strategy``.  ``fused``: the ring part runs through the fused
    ring flash kernel (``ops/ring_flash.ring_flash_attn_with_lse``, its
    plain twin on CPU tensors).  Returns (B, Sq_local, H, D) in q.dtype."""
    # validate before the ring-of-1 early return: an unknown strategy would
    # otherwise drop the joint K/V silently
    if joint_strategy not in ("none", "front", "rear"):
        raise ValueError(f"joint_strategy must be none/front/rear, got {joint_strategy!r}")
    if causal and joint_k is not None:
        raise ValueError("causal ring does not support joint tensors")
    ring_size = 1 if mesh is None else mesh.axis_size(axis)
    if ring_size == 1:
        kk, vv = with_joint(k, v, joint_k, joint_v, joint_strategy, 0, 1)
        out, _ = attn_with_lse(q, kk, vv, scale=scale, causal=causal)
        return out
    if fused and not causal:
        return _fused_ring(q, k, v, mesh, axis, scale, joint_k, joint_v, joint_strategy)

    my = mesh.axis_index(axis)
    out = lse = None
    for step, (blk_k, blk_v) in enumerate(ring_blocks((k, v), mesh, axis)):
        kk, vv = with_joint(blk_k, blk_v, joint_k, joint_v, joint_strategy, step, ring_size)
        block_out, block_lse = attn_with_lse(q, kk, vv, scale=scale, causal=causal and step == 0)
        if causal and step > my:
            # a later rank's block: computed, then gated out of the merge
            block_lse = torch.full_like(block_lse, float("-inf"))
            block_out = torch.zeros_like(block_out)
        out, lse = merge_out_lse(out, lse, block_out, block_lse)
    return out.to(q.dtype)


def _fused_ring(q, k, v, mesh, axis, scale, joint_k, joint_v, joint_strategy):
    """The ring part through the fused ring flash kernel, one launch per
    hop; the replicated joint block merges after (the merge is
    order-independent)."""
    from compactfusion_tpu_torch.ops.ring_flash import ring_flash_attn_with_lse

    out, lse = ring_flash_attn_with_lse(q, ring_blocks((k, v), mesh, axis), mesh.axis_size(axis),
                                        scale=scale)
    if joint_k is not None and joint_strategy != "none":
        j_out, j_lse = attn_with_lse(q, joint_k, joint_v, scale=scale)
        out, lse = merge_out_lse(out, lse, j_out, j_lse)
    return out.to(q.dtype)
