"""The compressed ring across ranks vs the JAX package, in fp32.

One spawn of 4 gloo processes runs the port's ``compact_ring_attention``
over 3 drifting steps for every case, unfused and fused (the twin of the
fused compressed ring kernel on CPU tensors), at ring 2 (on a dp 2 x ring 2
mesh: both dp lines run the same inputs) and one case at ring 4.  Each
rank's output shard and EF stack are held against the JAX unfused ring on
the 8-device CPU mesh: outputs < 5e-5 and stacks < 1e-6 relative (1e-4
where a subspace iteration fits the scales: the two frameworks' QRs differ
in the last fp32 bits and the factors are then rounded to bf16 for the
wire, which moves a few of them by one bf16 step; the JAX start basis is
handed to the port; 1e-3 for LOW_RANK_AWL, whose row weights,
a norm summed in another order, move the fit before that rounding), and
every rank's stack equals every other's bit for bit.  Two fused cases are also held against the Pallas kernel
``compact_binary_ring_flash`` in interpret mode, and the per-head packers
against JAX bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.compact import codecs as jcodecs
from compactfusion_tpu.compact.ring import compact_ring_attention as jcompact
from compactfusion_tpu.compact.ring import init_ring_state as jinit
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.ops import ring_flash_pallas as jrf
from compactfusion_tpu_torch.compact import ring as tring
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.ops import ring_flash as trf
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err
from tests.test_torch_lowrank import jax_init_q
from tests.test_torch_rank_fns import compact_ring_outputs

H, D, S_LOCAL, STEPS = 2, 16, 16, 3
OUT_REL, BASE_REL, FIT_REL, AWL_REL = 5e-5, 1e-6, 1e-4, 1e-3
# (codec, comp_rank, batch, int8 bases, ring)
CASES = [("binary", -1, 1, False, 2), ("binary", 2, 1, False, 2), ("int2", -1, 1, False, 2),
         ("low-rank", 2, 1, False, 2), ("low-rank", 2, 2, False, 2), ("low-rank-awl", 2, 1, False, 2),
         ("binary", -1, 1, True, 2), ("low-rank", 2, 1, True, 2), ("binary", -1, 2, False, 4)]
INTERPRET = [("binary", -1, 1, False, 2), ("low-rank", 2, 2, False, 2)]


def _cfg(cls, types, codec, rank, quantized):
    return cls(enabled=True, compress_type=types(codec), comp_rank=rank, residual=1,
               error_feedback=True, warmup_steps=0, quantized_cache=quantized)


def _steps(b, ring, seed):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((b, S_LOCAL * ring, H, D)) for _ in range(3)]
    out = []
    for _ in range(STEPS):
        x = [a + 0.05 * rng.standard_normal(a.shape) for a in x]
        out.append(tuple(a.astype(np.float32) for a in x))
    return out


def _seed(case):
    return CASES.index(case) if case in CASES else 99


@pytest.fixture(scope="module")
def spawned():
    inputs = {c: _steps(c[2], c[4], _seed(c)) for c in CASES}
    init_q = {(H * D, 2): jax_init_q(H * D, 2)}
    return tmesh.spawn_local(compact_ring_outputs, 4, "gloo", CASES, inputs, init_q, S_LOCAL, H * D,
                             threads=1, timeout=300)


@functools.lru_cache(maxsize=None)
def _jax_run(case, fused):
    """JAX per step: (out (B, S, H, D), stack leaves with a leading device axis)."""
    codec, rank_k, b, quantized, ring = case
    cfg = _cfg(JCompact, JType, codec, rank_k, quantized)
    mesh = JMesh(np.array(jax.devices()[:ring]), ("ring",))
    spec = P(None, "ring", None, None)

    def body(q, k, v, state):
        state = jax.tree_util.tree_map(lambda a: a[0], state)
        out, new = jcompact(q, k, v, state, cfg=cfg, method=cfg.compress_type, axis_name="ring",
                            ring_size=ring, fused=fused)
        return out, jax.tree_util.tree_map(lambda a: a[None], new)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P("ring")),
                               out_specs=(spec, P("ring")), check_vma=False))
    state = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (ring,) + a.shape),
                                   jinit(ring, b * S_LOCAL, H * D, jnp.float32, 1, quantized))
    res = []
    for q, k, v in _steps(b, ring, _seed(case)):
        out, state = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), state)
        res.append((np.asarray(out), state))
    return res


def _decoded(leaves, quantized):
    """(k stack, v stack) in fp32; int8 stacks decoded."""
    if not quantized:
        return leaves[0], leaves[1]
    dec = lambda q, s, mn: q.astype(np.float32) * s.astype(np.float32) + mn.astype(np.float32)
    return dec(*leaves[:3]), dec(*leaves[3:])


def _jax_stacks(state, dev, quantized):
    def one(entry):
        if quantized:
            e = jcodecs.Int8Payload(*(np.asarray(t)[dev] for t in entry))
            return np.asarray(e.q, np.float32) * np.asarray(e.scale, np.float32) + np.asarray(e.minv, np.float32)
        return np.asarray(entry)[dev]
    return one(state.k.base), one(state.v.base)


def _bounds(case):
    """(output, stack) bounds of a case."""
    if case[0] == "low-rank-awl":
        return AWL_REL, AWL_REL
    if case[0] == "low-rank" or case[1] > 0:
        return FIT_REL, FIT_REL
    return OUT_REL, BASE_REL


def _check(spawned, case, fused, ref, out_rel, base_rel):
    codec, rank_k, b, quantized, ring = case
    for step, (ref_out, ref_state) in enumerate(ref):
        shards = np.split(ref_out, ring, axis=1)
        for rank, res in enumerate(spawned):
            out, leaves = res[case + (fused,)][step]
            assert rel_err(out, shards[rank % ring]) < out_rel, (step, rank)
            for got, want in zip(_decoded(leaves, quantized), _jax_stacks(ref_state, rank % ring, quantized)):
                assert rel_err(got, want) < base_rel, (step, rank)
            # the consistency invariant: every rank's stack is bit-equal
            for a, z in zip(leaves, spawned[0][case + (fused,)][step][1]):
                np.testing.assert_array_equal(a, z)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-r{c[1]}-b{c[2]}" + "-int8" * c[3]
                         + f"-ring{c[4]}")
def test_compact_ring_matches_jax(spawned, case, fused):
    _check(spawned, case, fused, _jax_run(case, False), *_bounds(case))


@pytest.mark.parametrize("case", INTERPRET, ids=lambda c: f"{c[0]}-r{c[1]}-b{c[2]}")
def test_fused_twin_matches_pallas_interpret(spawned, case):
    """The port's fused route against the fused Pallas kernel (interpret
    mode) on the same drifting steps."""
    _check(spawned, case, True, _jax_run(case, "interpret"), *_bounds(case))


def test_per_head_packers_match_jax():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 3, 5, 16)).astype(np.uint8)
    crumbs = rng.integers(0, 4, (2, 3, 5, 16)).astype(np.uint8)
    np.testing.assert_array_equal(trf.pack_bits_per_head(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jrf.pack_bits_per_head(jnp.asarray(bits))))
    np.testing.assert_array_equal(trf.pack_2bit_per_head(torch.from_numpy(crumbs)).numpy(),
                                  np.asarray(jrf.pack_2bit_per_head(jnp.asarray(crumbs))))
    # the twin's unpacking inverts them
    np.testing.assert_array_equal(trf._unpack_per_head(trf.pack_bits_per_head(torch.from_numpy(bits)), 1).numpy(), bits)
    np.testing.assert_array_equal(trf._unpack_per_head(trf.pack_2bit_per_head(torch.from_numpy(crumbs)), 2).numpy(), crumbs)


def test_fused_route_conditions():
    """The JAX package's conditions for the fused compressed ring, as the
    port evaluates them (one decision on every rank)."""
    q = k = torch.zeros(1, 16, H, D)
    st = tring.init_ring_state(2, 16, H * D, torch.float32, 1)
    cfg = _cfg(CompactConfig, CompressType, "binary", -1, False)
    B, LR = CompressType.BINARY, CompressType.LOW_RANK
    assert tring._fused_route(q, k, st, cfg, B, 2, True)
    assert not tring._fused_route(q, k, st, cfg, B, 2, False)
    assert not tring._fused_route(q, k, st, cfg, B, 1, True)
    assert not tring._fused_route(q, k, st, cfg, CompressType.WARMUP, 2, True)
    assert not tring._fused_route(q, k, st, cfg, LR, 2, True)  # LOW_RANK needs comp_rank >= 1
    assert tring._fused_route(q, k, st, _cfg(CompactConfig, CompressType, "low-rank", 2, False), LR, 2, True)
    assert not tring._fused_route(q[:, :12], k, st, cfg, B, 2, True)  # q rows % 8
    quant = _cfg(CompactConfig, CompressType, "binary", -1, True)
    assert tring._fused_route(q, k, st, quant, B, 2, True)
    assert not tring._fused_route(q, torch.zeros(2, 16, H, D), st, quant, B, 2, True)  # int8 at B > 1
    r2 = tring.init_ring_state(2, 16, H * D, torch.float32, 2)
    assert not tring._fused_route(q, k, r2, CompactConfig(enabled=True, residual=2), B, 2, True)
