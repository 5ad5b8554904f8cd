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

The CUDA kernel 8 splits each hop into an EF pass over tiles of the slot
(int8 stacks: the per-channel min and max per row tile, reduced across the
tiles, then the codes decoded with a copy of the old scale and min) and
kernel 7's carried flash partial on the bf16 reconstruction.  A torch model
of that split is held against the fused twin ``compact_ring_flash_ref``
below, in one process: stacks bit for bit, out and LSE within 2e-5 (fp32
summation order).
"""

import functools
import types

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
from compactfusion_tpu_torch.compact import codecs as tcodecs
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


# -- the split hop of the CUDA kernel 8, modelled in torch --------------------

SPLIT_ATOL = 2e-5
# (codec, comp_rank, batch): every fused codec; int8 stacks take B == 1
SPLIT_CODECS = [("binary", -1), ("binary", 2), ("int2", -1), ("lowrank", 2)]


def _tile_min_max(x):
    """The EF pass's per-channel min and max of x (N, C): per tile of
    ``EF_ROWS`` rows (its first kernel), then reduced across the tiles in
    order (its second)."""
    tiles = [torch.aminmax(x[r:r + trf.EF_ROWS], dim=0) for r in range(0, x.shape[0], trf.EF_ROWS)]
    mn, mx = tiles[0]
    for lo, hi in tiles[1:]:
        mn, mx = torch.minimum(mn, lo), torch.maximum(mx, hi)
    return mn[None], mx[None]


def _ef_pass_model(base, src, codec, packed, u, v):
    """The EF pass on one stack, as the kernels order it: fp32 slots rebuilt
    in place element by element; int8 slots rebuilt from a copy of the old
    scale and min, coded against the tiles' min and max, and the new scale
    and min written after every code.  Returns the reconstruction (N, C)."""
    delta = trf.payload_delta(codec, packed, u, v)
    if not isinstance(base, tcodecs.Int8Payload):
        blk = base[src] + delta
        base[src].copy_(blk)
        return blk
    old = tcodecs.Int8Payload(base.q[src].clone(), base.scale[src].clone(), base.minv[src].clone())
    blk = tcodecs.decode_int8(old) + delta
    mn, mx = _tile_min_max(blk)
    sc = (mx - mn + 1e-6) / torch.full_like(mn, 255.0)
    base.q[src].copy_(torch.round((blk - mn) / sc).clamp(0, 255).to(torch.uint8))
    base.scale[src].copy_(sc.to(torch.bfloat16))
    base.minv[src].copy_(mn.to(torch.bfloat16))
    return blk


def _split_hops(q, k, v, k_base, v_base, payloads, codec, my, ring):
    """Kernel 8 as the CUDA path runs it: per hop the EF pass of slot
    (my - s) % R over the whole slot, then a flash partial carried in
    (m, l, acc) in the exp2 domain, on the exact K/V at hop 0 and the
    reconstruction (in k.dtype) after; the last hop normalises."""
    b, sq, h, d = q.shape
    scale = d**-0.5 * 1.4426950408889634
    m = torch.full((b, h, sq), float("-inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for step, payload in enumerate(payloads):
        pk, pv, uk, uv, vk, vv = trf._split_payload(codec, payload)
        src = (my - step) % ring
        k_rec = _ef_pass_model(k_base, src, codec, pk, uk, vk)
        v_rec = _ef_pass_model(v_base, src, codec, pv, uv, vv)
        kk, vv_ = (k, v) if step == 0 else (k_rec.reshape(k.shape).to(k.dtype), v_rec.reshape(v.shape).to(v.dtype))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp2(sc - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vv_)
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3), (m + torch.log2(l)) / 1.4426950408889634


def _split_inputs(codec, rank, quantized, ring, b, sk, seed):
    """Every virtual rank's q/k/v, the stacks they start from and every
    rank's fused payload made from its own K/V and slot."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    n, c = b * sk, H * D
    shards = [tuple(rnd(b, sk, H, D) for _ in range(3)) for _ in range(ring)]

    def stack():
        slots = [rnd(n, c) * 0.9 for _ in range(ring)]
        if not quantized:
            return torch.stack(slots)
        return tcodecs.Int8Payload(*(torch.stack(p) for p in zip(*map(tcodecs.encode_int8, slots))))

    kb0, vb0 = stack(), stack()
    payloads = [trf.fused_ring_payload(shards[r][1], shards[r][2], trf.decode_slot(kb0, r),
                                       trf.decode_slot(vb0, r), codec, rank) for r in range(ring)]
    return shards, kb0, vb0, payloads


def _clone(base):
    if isinstance(base, tcodecs.Int8Payload):
        return tcodecs.Int8Payload(*(t.clone() for t in base))
    return base.clone()


@pytest.mark.parametrize("ring,b", [(2, 1), (4, 2)])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("codec,rank", SPLIT_CODECS, ids=lambda x: str(x))
def test_split_hop_model_matches_the_fused_twin(codec, rank, quantized, ring, b):
    """The EF pass over the whole slot, then a carried flash partial, hop by
    hop: the same stacks bit for bit as the fused twin, and its out and LSE.
    96 rows per slot at B1 (two row tiles, the second ragged)."""
    if quantized and b != 1:
        b = 1
    shards, kb0, vb0, payloads = _split_inputs(codec, rank, quantized, ring, b, 96 // b, seed=ring + rank)
    for my in range(ring):
        arriving = [payloads[(my - s) % ring] for s in range(ring)]
        kr, vr, km, vm = _clone(kb0), _clone(vb0), _clone(kb0), _clone(vb0)
        ref_out, ref_lse = trf.compact_ring_flash_ref(*shards[my], kr, vr, iter(arriving), codec=codec, my=my,
                                                      ring_size=ring)
        out, lse = _split_hops(*shards[my], km, vm, arriving, codec, my, ring)
        for got, want in ((km, kr), (vm, vr)):
            for a, z in zip(got if quantized else (got,), want if quantized else (want,)):
                assert torch.equal(a, z)
        np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=SPLIT_ATOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=SPLIT_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 96, 512, 1000])
def test_row_tile_min_max_equals_aminmax_bit_for_bit(n):
    """Min and max are exact in any order: per row tile, then across the
    tiles, they are torch.aminmax's bits (ties included)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(np.round(rng.standard_normal((n, 40)) * 8).astype(np.float32) / 8 + 0.01)
    mn, mx = _tile_min_max(x)
    ref_mn, ref_mx = torch.aminmax(x, dim=0, keepdim=True)
    assert torch.equal(mn.view(torch.int32), ref_mn.view(torch.int32))
    assert torch.equal(mx.view(torch.int32), ref_mx.view(torch.int32))


def test_ef_update_slot_runs_its_twin_on_cpu():
    """On CPU stacks the EF pass's wrapper is its twin: the new bases, and
    the reconstruction rounded into ``rec``; it counts no launch."""
    shards, kb0, vb0, payloads = _split_inputs("binary", -1, False, 2, 1, 32, seed=7)
    shape = tuple(shards[0][1].shape)
    kr, vr, kw, vw = _clone(kb0), _clone(vb0), _clone(kb0), _clone(vb0)
    rec = tuple(torch.empty(shape, dtype=torch.bfloat16) for _ in range(2))
    trf.ef_update_slot.launches = 0
    trf.ef_update_slot(kw, vw, 1, "binary", payloads[1], shape, rec=rec)
    want = trf.ef_update_slot_ref(kr, vr, 1, "binary", payloads[1])
    assert torch.equal(kw, kr) and torch.equal(vw, vr) and trf.ef_update_slot.launches == 0
    for r, x in zip(rec, want):
        assert torch.equal(r, x.reshape(shape).to(torch.bfloat16))
    with pytest.raises(ValueError, match="B == 1"):
        trf.ef_update_slot(tcodecs.encode_int8(kb0[0]), None, 0, "binary", payloads[0], (2, 16, H, D))


class _FakeLib:
    """Stands in for the kernel library: records the EF pass's C call."""

    def __init__(self):
        self.calls = []

    def cf_ef_update_slot(self, *args):
        self.calls.append(args)
        return 0


def _declared_argtypes(name):
    """The argtypes ``ops/_build.py::_declare`` gives the C entry ``name``."""
    from compactfusion_tpu_torch.ops import _build

    class Lib:
        def __getattr__(self, attr):
            setattr(self, attr, types.SimpleNamespace())
            return getattr(self, attr)

    lib = Lib()
    _build._declare(lib)
    return getattr(lib, name).argtypes


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_ef_launch_passes_the_c_entry_its_arguments(quantized):
    """The EF pass's launch hands ``cf_ef_update_slot`` its arguments in the
    order ``ops/_build.py`` declares them: the payload, slot ``src`` of both
    stacks, the reconstruction, the int8 scratch, the shape and whether the
    reconstruction is fp32; it counts one launch on fp32 stacks and two on
    int8 stacks."""
    shards, kb, vb, payloads = _split_inputs("binary", 2, quantized, 2, 1, 96, seed=3)
    shape = tuple(shards[0][1].shape)
    n, c = 96, H * D
    parts = trf._check_payload("binary", payloads[1], *shape)
    rec = tuple(torch.empty(shape, dtype=torch.bfloat16) for _ in range(2))
    scratch = trf._ef_scratch(quantized, n, c, "cpu")
    lib = _FakeLib()
    trf.ef_update_slot.launches = 0
    trf._ef_launch(lib, kb, vb, 1, "binary", parts, shape, rec, scratch, 7, torch.bfloat16)
    (args,) = lib.calls
    assert len(args) == len(_declared_argtypes("cf_ef_update_slot"))
    pk, pv, uk, uv, vk, vv = parts
    assert args[:7] == (pk.data_ptr(), pv.data_ptr(), uk.data_ptr(), uv.data_ptr(), vk.data_ptr(),
                        vv.data_ptr(), 2)
    if quantized:
        assert args[7:13] == (kb.q[1].data_ptr(), kb.scale[1].data_ptr(), kb.minv[1].data_ptr(),
                              vb.q[1].data_ptr(), vb.scale[1].data_ptr(), vb.minv[1].data_ptr())
        assert args[15:18] == (scratch[0].data_ptr(), scratch[1].data_ptr(), 2)
        assert tuple(scratch[0].shape) == (2, 2, 2, c) and tuple(scratch[1].shape) == (2, 2, c)
    else:
        assert args[7:13] == (kb[1].data_ptr(), None, None, vb[1].data_ptr(), None, None)
        assert args[15:18] == (None, None, 2)
    assert args[13:15] == (rec[0].data_ptr(), rec[1].data_ptr())
    assert args[18:] == (1, 96, H, D, 0, int(quantized), 0, 7)
    assert trf.ef_update_slot.launches == (2 if quantized else 1)
