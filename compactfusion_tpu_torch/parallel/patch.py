"""Patch parallelism: full-K/V all-gather attention and DistriFusion's
stale gather (counterpart of ``compactfusion_tpu/parallel/patch.py``).

The alternative to ring attention when CompactFusion runs patch-parallel
(``CompactConfig.patch_gather``), on the ring axis of the mesh:

* sync: all-gather the whole K/V every step, full flash attention here;
* compact: the all-gather carries compressed deltas with error feedback
  (``compact/allgather.compact_all_gather``); with ``check_consistency``
  every slot is held equal across the ranks after the gather, as the
  compressed ring's are;
* async (DistriFusion): attend to last step's gathered K/V with this
  step's own slice swapped in, while this step's K/V is gathered for the
  next step (started before the attention, finished after it).

Every route ends in ``attn_with_lse`` (kernel 1 on CUDA tensors) over the
W * S_local gathered keys, laid out contiguous (B, S, H, D).  The state of
each layer is updated in place, as the ring strategies' is.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from compactfusion_tpu_torch.compact.allgather import compact_all_gather
from compactfusion_tpu_torch.compact.engine import EFState
from compactfusion_tpu_torch.compact.ring import consistency_assert, init_ring_state
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.ops.attention import attn_with_lse
from compactfusion_tpu_torch.parallel import ring
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, Mesh


class PatchKVCache(NamedTuple):
    """DistriFusion's stale K/V, gathered at the previous step."""

    k: torch.Tensor  # (W, B, S_local, H, D)
    v: torch.Tensor


class PatchEFState(NamedTuple):
    """The compressed all-gather's EF caches for K and V."""

    k: EFState  # leaves (W, N, C)
    v: EFState


def _flat(g: torch.Tensor, dtype) -> torch.Tensor:
    """(W, B, S_local, H, D) in source-rank order -> contiguous (B, W *
    S_local, H, D) in ``dtype``."""
    w, b, s, h, d = g.shape
    return g.transpose(0, 1).reshape(b, w * s, h, d).to(dtype)


@dataclasses.dataclass(frozen=True)
class PatchParallelAttn:
    """Patch-parallel attention strategy over ``mesh``'s ``axis``.

    ``mode``: "sync", "compact" or "async" (DistriFusion).  ``method``: the
    codec of this denoise step in compact mode (WARMUP in the warmup
    steps); async mode gathers fresh K/V in its WARMUP steps too."""

    cfg: Optional[CompactConfig] = None
    method: Optional[CompressType] = None
    mode: str = "sync"
    mesh: Optional[Mesh] = None
    axis: str = AXIS_RING

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(self.axis)

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        """Compact: EF caches with leaves (L, W, N, C), N = batch *
        seq_local, C = heads * head_dim (``Int8Payload`` entries with
        ``cfg.quantized_cache``); async: zero K/V (L, W, B, S_local, H, D)."""
        if self.mode == "sync" or self.world == 1:
            return ()
        if self.mode == "compact":
            st = init_ring_state(self.world, batch * seq_local, heads * head_dim, dtype,
                                 self.cfg.residual if self.cfg else 1,
                                 bool(self.cfg and self.cfg.quantized_cache), device, layers=n_layers)
            return PatchEFState(k=st.k, v=st.v)
        if self.mode == "async":
            z = torch.zeros((n_layers, self.world, batch, seq_local, heads, head_dim), dtype=dtype,
                            device=device)
            return PatchKVCache(k=z, v=z.clone())
        raise ValueError(self.mode)

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        if joint_q is not None:
            if joint_strategy != "front":
                raise ValueError(f"joint_strategy {joint_strategy!r}: only 'front'")
            q = torch.cat([joint_q, q], dim=1)

        if self.world == 1 or self.mode == "sync":
            if self.world > 1:
                gk, gv = self.mesh.all_gather_tree((k, v), self.axis)
                k, v = _flat(gk, k.dtype), _flat(gv, v.dtype)
            out, _ = attn_with_lse(q, *ring.with_joint(k, v, joint_k, joint_v, "front", 0, 1))
            return out, state

        if self.mode == "compact":
            b, s, h, d = k.shape
            gk, _ = compact_all_gather(k.reshape(b * s, h * d), state.k, cfg=self.cfg, method=self.method,
                                       mesh=self.mesh, axis=self.axis)
            gv, _ = compact_all_gather(v.reshape(b * s, h * d), state.v, cfg=self.cfg, method=self.method,
                                       mesh=self.mesh, axis=self.axis)
            if self.cfg.check_consistency:
                consistency_assert(state, self.mesh, self.axis)
            kk = _flat(gk.reshape(self.world, b, s, h, d), k.dtype)
            vv = _flat(gv.reshape(self.world, b, s, h, d), v.dtype)
            out, _ = attn_with_lse(q, *ring.with_joint(kk, vv, joint_k, joint_v, "front", 0, 1))
            return out, state

        if self.mode == "async":
            # this step's K/V for the next step (and, in warmup, for this one)
            wait = self.mesh.all_gather_tree((k, v), self.axis, async_op=True)
            warmup = self.method == CompressType.WARMUP
            if warmup:
                for cache, gathered in zip(state, wait()):
                    cache.copy_(gathered)
            else:
                # the stale remote K/V with the fresh local slice swapped in;
                # the gather refills the cache after the attention has read it
                my = self.mesh.axis_index(self.axis)
                state.k[my].copy_(k)
                state.v[my].copy_(v)
            kk, vv = _flat(state.k, k.dtype), _flat(state.v, v.dtype)
            out, _ = attn_with_lse(q, *ring.with_joint(kk, vv, joint_k, joint_v, "front", 0, 1))
            if not warmup:
                for cache, gathered in zip(state, wait()):
                    cache.copy_(gathered)
            return out, state

        raise ValueError(self.mode)
