"""Self-attention strategies (counterpart of ``compactfusion_tpu/models/attn_impl.py``).

Every strategy has the call shape ``out, state = impl(q, k, v, state)`` on
(B, S, H, D) tensors and an ``init_state`` that builds the per-layer state
stacked on a leading layer axis.  Ported: :class:`SingleDeviceAttn`, the
single-device compressed-ring emulation :class:`SimRingAttn`, and
sequence parallelism across ranks (Ulysses x ring), plain (:class:`USPAttn`)
and compressed (:class:`CompactUSPAttn`), each on a ``parallel.mesh.Mesh``;
the patch-parallel gather is ``parallel/patch.PatchParallelAttn``; the
patch-pipelined PipeFusion's stale-K/V attention is :class:`PatchKVAttn`,
and :class:`PatchKVUlyssesAttn` under Ulysses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from compactfusion_tpu_torch.compact import codecs, stats
from compactfusion_tpu_torch.compact.engine import ef_compress, ef_decompress
from compactfusion_tpu_torch.compact.ring import (
    CompactRingState,
    compact_usp_attention,
    init_ring_state,
    set_slot,
    slot,
)
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.ops.attention import sdpa
from compactfusion_tpu_torch.parallel import ulysses as uly
from compactfusion_tpu_torch.parallel.mesh import AXIS_RING, AXIS_ULYSSES, Mesh
from compactfusion_tpu_torch.parallel.usp import usp_attention


@dataclasses.dataclass(frozen=True)
class SingleDeviceAttn:
    """Plain attention: the no-parallelism baseline."""

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        return ()

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        if joint_q is not None:
            if joint_strategy != "front":
                raise ValueError(f"joint_strategy {joint_strategy!r}: only 'front'")
            q = torch.cat([joint_q, q], dim=1)
            k = torch.cat([joint_k, k], dim=1)
            v = torch.cat([joint_v, v], dim=1)
        return sdpa(q, k, v), state


@dataclasses.dataclass(frozen=True)
class USPAttn:
    """Uncompressed hybrid Ulysses x ring sequence parallelism over the
    mesh's ulysses and ring axes.  ``fused_ring``: the fused ring flash
    kernel carries the ring."""

    mesh: Optional[Mesh]
    ulysses_size: int = 1
    fused_ring: bool = False

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        return ()

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        out = usp_attention(q, k, v, mesh=self.mesh, ulysses_size=self.ulysses_size,
                            joint_q=joint_q, joint_k=joint_k, joint_v=joint_v,
                            joint_strategy=joint_strategy if joint_q is not None else "none",
                            fused_ring=self.fused_ring)
        return out, state


@dataclasses.dataclass(frozen=True)
class CompactUSPAttn:
    """CompactFusion: sequence parallelism with the compressed ring and its
    EF state.  ``method`` is the codec of the current denoise step (the
    pipeline builds one strategy per step segment); ``fused_ring`` routes
    residual 1 + EF BINARY/INT2/LOW_RANK through the fused compressed ring
    kernel."""

    cfg: CompactConfig
    method: CompressType
    mesh: Optional[Mesh]
    ulysses_size: int = 1
    fused_ring: bool = False

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        """This rank's ring caches, leaves (L, R, N, C) at the ring loop's
        shapes after the Ulysses all-to-all: R the mesh's ring size, N =
        batch * seq_local * U, C = (heads / U) * head_dim (``Int8Payload``
        entries with ``cfg.quantized_cache``)."""
        ring_size = 1 if self.mesh is None else self.mesh.axis_size(AXIS_RING)
        return init_ring_state(ring_size, batch * seq_local * self.ulysses_size,
                               (heads // self.ulysses_size) * head_dim, dtype, self.cfg.residual,
                               self.cfg.quantized_cache, device, layers=n_layers)

    def __call__(self, q, k, v, state: CompactRingState, *, joint_q=None, joint_k=None,
                 joint_v=None, joint_strategy="front"):
        """``state``: this layer's caches, leaves (R, N, C), updated in place."""
        return compact_usp_attention(
            q, k, v, state, cfg=self.cfg, method=self.method, mesh=self.mesh,
            ulysses_size=self.ulysses_size, joint_q=joint_q, joint_k=joint_k, joint_v=joint_v,
            joint_strategy=joint_strategy if joint_q is not None else "none",
            fused=self.fused_ring)


def _joint_front(q, k, v, joint_q, joint_k, joint_v, joint_strategy):
    """The joint (text) rows in front of q, k and v: always fresh, never
    cached (only image K/V ages)."""
    if joint_q is None:
        return q, k, v
    if joint_strategy != "front":
        raise ValueError(f"joint_strategy {joint_strategy!r}: only 'front'")
    return (torch.cat([joint_q, q], dim=1), torch.cat([joint_k, k], dim=1),
            torch.cat([joint_v, v], dim=1))


def _write_patch(state, k, v, offset: int):
    """Write the fresh patch K/V into the layer's full-sequence caches at
    ``offset`` (in place) and return the caches in k's dtype."""
    s = k.shape[1]
    state["k_cache"][:, offset:offset + s] = k
    state["v_cache"][:, offset:offset + s] = v
    return state["k_cache"].to(k.dtype), state["v_cache"].to(v.dtype)


@dataclasses.dataclass(frozen=True)
class PatchKVAttn:
    """PipeFusion's patched attention: the current patch's fresh K/V are
    written into the full-sequence K/V cache at its token ``offset``, and
    the patch queries attend the whole, partly stale, sequence (reference
    ``CacheManager._naive_cache_update``, ``cache_manager.py:105``).  The
    pipeline sets ``offset`` for each micro-round (``dataclasses.replace``);
    the JAX package keeps it in the state.

    State (stacked per layer): ``k_cache``/``v_cache`` (L, B, S_total, H, D)
    in the model dtype."""

    offset: int = 0

    def init_state(self, n_layers, batch, seq_total, heads, head_dim, dtype, device=None):
        z = torch.zeros((n_layers, batch, seq_total, heads, head_dim), dtype=dtype, device=device)
        return {"k_cache": z, "v_cache": z.clone()}

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        k_full, v_full = _write_patch(state, k, v, self.offset)
        q, k_full, v_full = _joint_front(q, k_full, v_full, joint_q, joint_k, joint_v, joint_strategy)
        return sdpa(q, k_full, v_full), state


@dataclasses.dataclass(frozen=True)
class PatchKVUlyssesAttn:
    """:class:`PatchKVAttn` under Ulysses (reference
    ``CacheManager._sequence_parallel_cache_update``, ``cache_manager.py:
    140``): the stale cache is sharded by heads (each Ulysses rank holds
    H / U heads of every token), the fresh patch arrives sharded by tokens
    and the all-to-all swaps it to heads; the cache takes it at ``offset``,
    the patch queries attend the whole sequence, and the inverse all-to-all
    restores the token sharding.  Joint (text) rows, replicated, are cut to
    this rank's heads and their output heads gathered back."""

    mesh: Mesh
    ulysses_size: int
    offset: int = 0

    def init_state(self, n_layers, batch, seq_total, heads, head_dim, dtype, device=None):
        z = torch.zeros((n_layers, batch, seq_total, heads // self.ulysses_size, head_dim), dtype=dtype,
                        device=device)
        return {"k_cache": z, "v_cache": z.clone()}

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        m, u = self.mesh, self.ulysses_size
        q, k, v = (uly.scatter_heads_gather_seq(t, m) for t in (q, k, v))  # (B, s_patch, H/U, D)
        k_full, v_full = _write_patch(state, k, v, self.offset)
        if joint_q is not None:
            joint_q, joint_k, joint_v = (uly.slice_joint_heads(t, m, u) for t in (joint_q, joint_k, joint_v))
        q, k_full, v_full = _joint_front(q, k_full, v_full, joint_q, joint_k, joint_v, joint_strategy)
        out = sdpa(q, k_full, v_full)
        if joint_q is None:
            return uly.scatter_seq_gather_heads(out, m), state
        s_j = joint_q.shape[1]
        # the joint rows, computed for this rank's heads on every rank, get
        # their heads back; the patch rows their token sharding
        out_j = torch.cat(m.all_gather(out[:, :s_j].contiguous(), AXIS_ULYSSES), dim=2)
        out_p = uly.scatter_seq_gather_heads(out[:, s_j:], m)
        return torch.cat([out_j, out_p], dim=1), state


@dataclasses.dataclass(frozen=True)
class SimRingAttn:
    """Single-device emulation of the compressed ring, at topology fidelity.

    The sequence splits into R chunks; each chunk's K/V runs the EF state
    machine of a ring rank's own block (``engine.ef_compress``), and query
    chunk i attends its own chunk exact plus the other R-1 chunks as the
    receivers reconstruct them: the K/V mix device i sees in a real
    ``ring_degree=R`` run.  Joint (text) K/V is appended exact.
    """

    cfg: CompactConfig
    method: CompressType
    ring_size: int

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        """EF caches with leaves (L, R, N, C), N = batch * S / R, C = H * D
        (``Int8Payload`` entries with ``cfg.quantized_cache``)."""
        if seq_local % self.ring_size:
            raise ValueError(f"sequence {seq_local} does not split into {self.ring_size} chunks")
        n = batch * (seq_local // self.ring_size)
        return init_ring_state(self.ring_size, n, heads * head_dim, dtype, self.cfg.residual,
                               self.cfg.quantized_cache, device, layers=n_layers)

    def __call__(self, q, k, v, state: CompactRingState, *, joint_q=None, joint_k=None,
                 joint_v=None, joint_strategy="front"):
        """``state``: this layer's caches, leaves (R, N, C).  The slots are
        updated in place and the same state is returned.  With
        ``cfg.log_stats`` each chunk records the spectra of its K and of its
        K delta against the slot's base (IDENTITY included: with EF that
        delta is the true step delta), and, on the codecs with residual 1 +
        EF, the K and V codec error against the post-EF base, under the
        wire ring's keys (one device: untagged, as in the JAX package)."""
        c = self.cfg
        taps = c.log_stats and not c.quantized_cache and self.method != CompressType.WARMUP
        spectra = taps and c.residual >= 1
        metrics = (taps and self.method != CompressType.IDENTITY and c.residual == 1
                   and c.error_feedback)
        if joint_q is not None:
            raise ValueError("joint queries are not emulated")
        b, s, h, d = k.shape
        R = self.ring_size
        sc = s // R

        k_chunks = torch.split(k, sc, dim=1)
        v_chunks = torch.split(v, sc, dim=1)
        recon_k, recon_v = [], []
        for j in range(R):
            k_st, v_st = slot(state.k, j), slot(state.v, j)
            k_nc, v_nc = k_chunks[j].reshape(b * sc, h * d), v_chunks[j].reshape(b * sc, h * d)
            if spectra:
                stats.log_spectrum_inside_jit("k-activation", k_nc.float())
                stats.log_spectrum_inside_jit("k-delta", k_nc.float() - k_st.base.float())
            # AWL: key-importance weights from the local V, for the K fit only
            awl = codecs.awl_row_scale(v_nc) if self.method == CompressType.LOW_RANK_AWL else None
            pk, k_new = ef_compress(k_nc, k_st, self.cfg, self.method, awl_scale=awl)
            pv, v_new = ef_compress(v_nc, v_st, self.cfg, self.method)
            # receiver view from the PRE-compress state: identical to the
            # sender's new base (the EF consistency invariant); taken before
            # the in-place slot write below overwrites that state
            rk, _ = ef_decompress(pk, k_st, self.cfg, self.method, update_cache=False)
            rv, _ = ef_decompress(pv, v_st, self.cfg, self.method, update_cache=False)
            recon_k.append(rk.reshape(b, sc, h, d).to(k.dtype))
            recon_v.append(rv.reshape(b, sc, h, d).to(v.dtype))
            if metrics:
                stats.log_inside_jit("k", -1, stats.compression_metrics(k_nc, k_new.base))
                stats.log_inside_jit("v", -1, stats.compression_metrics(v_nc, v_new.base))
            set_slot(state.k, j, k_new)
            set_slot(state.v, j, v_new)

        outs = []
        for i, q_i in enumerate(torch.split(q, sc, dim=1)):
            kk = [k_chunks[j] if j == i else recon_k[j] for j in range(R)]
            vv = [v_chunks[j] if j == i else recon_v[j] for j in range(R)]
            if joint_k is not None:
                if joint_strategy == "front":
                    kk, vv = [joint_k] + kk, [joint_v] + vv
                else:
                    kk, vv = kk + [joint_k], vv + [joint_v]
            outs.append(sdpa(q_i, torch.cat(kk, dim=1), torch.cat(vv, dim=1)))
        return torch.cat(outs, dim=1), state
