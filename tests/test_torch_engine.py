"""Port's error-feedback engine vs the JAX package, on short step sequences.

Steps: WARMUP, then a codec, on slowly drifting activations (the temporal
coherence the residual codecs exploit), for residual 0/1/2 on fp32 and bf16
states, int8-quantized caches and ``simulate`` mode.  Both sides run the
codec path on the CPU.  Packed payloads must match byte for byte; bases and
reconstructions agree to 1e-5 relative: the same arithmetic on both sides,
with the bf16 scale factors equal or one bf16 ulp apart (see
test_torch_quant.py); 1e-4 where a low-rank fit is involved
(test_torch_lowrank.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu import config as jconfig
from compactfusion_tpu.compact import engine as jengine
from compactfusion_tpu_torch import config as tconfig
from compactfusion_tpu_torch.compact import codecs as tcodecs
from compactfusion_tpu_torch.compact import engine as tengine
from compactfusion_tpu_torch.compact.ring import init_ring_state, set_slot, slot, tree_map
from compactfusion_tpu_torch.models.attn_impl import SimRingAttn

REL = 1e-5
N, C = 64, 128


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _steps(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C)).astype(np.float32)
    out = []
    for _ in range(3):
        out.append(x.copy())
        x = x + 0.1 * rng.standard_normal((N, C)).astype(np.float32)
    return out


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a if a.dtype == np.uint8 else a.astype(np.float32)


def _fields(payload):
    """Payload fields as numpy (a raw tensor for WARMUP, else a NamedTuple)."""
    return [_np(f) for f in payload] if isinstance(payload, tuple) else [_np(payload)]


@pytest.mark.parametrize("residual,dtype", [
    pytest.param(0, "float32", id="0"),
    pytest.param(1, "float32", id="1"),
    pytest.param(2, "float32", id="2"),
    pytest.param(2, "bfloat16", id="2-bf16"),
])
def test_ef_sequence_matches_jax(residual, dtype):
    """The bf16 residual-2 case holds the decay multiply: the JAX package
    rounds the factor to bf16 before the product; both sides then round
    every bf16 operation alike, so the same bound holds."""
    kw = dict(enabled=True, warmup_steps=1, residual=residual, error_feedback=residual != 0)
    jcfg = jconfig.CompactConfig(compress_type=jconfig.CompressType.BINARY, **kw)
    tcfg = tconfig.CompactConfig(compress_type=tconfig.CompressType.BINARY, **kw)
    jst = jengine.init_ef_state((N, C), getattr(jnp, dtype), residual)
    tst = tengine.init_ef_state((N, C), getattr(torch, dtype), residual)
    trecv = tst
    for step, x in enumerate(_steps(seed=residual)):
        jm = jcfg.type_at(0, step)
        tm = tcfg.type_at(0, step)
        assert jm.value == tm.value
        jpay, jst_new = jengine.ef_compress(jnp.asarray(x), jst, jcfg, jm)
        jhat, _ = jengine.ef_decompress(jpay, jst, jcfg, jm)
        tpay, tst_new = tengine.ef_compress(torch.from_numpy(x), tst, tcfg, tm)
        that, trecv = tengine.ef_decompress(tpay, trecv, tcfg, tm)

        for tf, jf in zip(_fields(tpay), _fields(jpay)):
            if tf.dtype == np.uint8:
                np.testing.assert_array_equal(tf, jf)
            else:  # raw tensors equal; bf16 scales at most one ulp (2^-7 rel) apart
                assert np.all(np.abs(tf - jf) <= 2.0**-7 * np.abs(jf))
        assert _rel(_np(that), _np(jhat)) <= REL
        assert _rel(_np(tst_new.base), _np(jst_new.base)) <= REL
        if residual == 2:
            assert _rel(_np(tst_new.delta_base), _np(jst_new.delta_base)) <= REL
        # the receiver's cache equals the sender's, bit for bit
        assert torch.equal(trecv.base, tst_new.base)
        jst, tst = jst_new, tst_new


def test_fastpath_compress_matches_codec_path():
    """The fused path (the kernels' twins on the CPU) gives the codec path's
    payload bytes and base for BINARY.  For INT2 the fused path thresholds on
    the wire-rounded scale and ``encode_int2`` on the fp32 one, so codes may
    differ where |delta| lies between the two; the fused payload decodes with
    the codec's decoder to the fused base update (bound 1e-6: one fp32 add)."""
    cfg = tconfig.CompactConfig(enabled=True, warmup_steps=0)
    B, I2 = tconfig.CompressType.BINARY, tconfig.CompressType.INT2
    x0, x1, _ = _steps(seed=7)
    st = tengine.EFState(base=torch.from_numpy(x0), delta_base=None)
    pay_f, st_f = tengine._fastpath_compress(torch.from_numpy(x1), st, cfg, B, True)
    pay_c, st_c = tengine.ef_compress(torch.from_numpy(x1), st, cfg, B)
    assert torch.equal(pay_f.packed, pay_c.packed)
    assert torch.equal(pay_f.scale_u, pay_c.scale_u) and torch.equal(pay_f.scale_v, pay_c.scale_v)
    assert _rel(st_f.base.numpy(), st_c.base.numpy()) <= 1e-6
    hat, _ = tengine._fastpath_decompress(pay_f, st, B, True)
    assert torch.equal(hat, st_f.base)

    pay_i, st_i = tengine._fastpath_compress(torch.from_numpy(x1), st, cfg, I2, True)
    assert isinstance(pay_i, tcodecs.Int2Payload) and pay_i.packed.shape == (N, C // 4)
    assert _rel((st.base + tcodecs.decode_int2(pay_i)).numpy(), st_i.base.numpy()) <= 1e-6
    hat, _ = tengine._fastpath_decompress(pay_i, st, I2, True)
    assert torch.equal(hat, st_i.base)


def test_fastpath_gate():
    """The gate of the fused kernels: residual 1 + EF, BINARY or INT2, no
    simulate, CUDA tensors.  Quantized caches and INT2 are ported, and the
    ring emulation runs with ``log_stats`` and records its metrics (the
    taps are held against JAX's in tests/test_torch_stats.py)."""
    cfg = tconfig.CompactConfig(enabled=True)
    B, I2 = tconfig.CompressType.BINARY, tconfig.CompressType.INT2
    assert tengine._use_fastpath(cfg, B, on_cuda=True)
    assert not tengine._use_fastpath(cfg, B, on_cuda=False)
    assert not tengine._use_fastpath(dataclasses.replace(cfg, fastpath=False), B, True)
    assert not tengine._use_fastpath(dataclasses.replace(cfg, residual=2), B, True)
    assert not tengine._use_fastpath(
        dataclasses.replace(cfg, residual=0, error_feedback=False), B, True)
    assert tengine._use_fastpath(cfg, I2, on_cuda=True)
    assert not tengine._use_fastpath(dataclasses.replace(cfg, simulate=True), I2, True)
    assert not tengine._use_fastpath(cfg, tconfig.CompressType.LOW_RANK, True)
    st = tengine.init_ef_state((4, 8), quantized=True)
    assert isinstance(st.base, tcodecs.Int8Payload) and isinstance(st.delta_base, tcodecs.Int8Payload)
    from compactfusion_tpu_torch.compact.stats import StatsLogger

    StatsLogger.reset()
    SimRingAttn(dataclasses.replace(cfg, log_stats=True), B, 2)(
        *(torch.ones(1, 4, 1, 8) for _ in range(3)), init_ring_state(2, 2, 8, torch.float32))
    log = StatsLogger.instance()
    assert [len(log.records[k]) for k in ("k", "v")] == [2, 2] and len(log.spectra["k-delta"]) == 2


def test_ring_slots_update_in_place():
    st = init_ring_state(3, 4, 8, torch.float32, residual=2, layers=2)
    assert st.k.base.shape == (2, 3, 4, 8) and st.v.delta_base.shape == (2, 3, 4, 8)
    layer = type(st)(*(type(s)(*(a[1] for a in s)) for s in st))
    new = tengine.EFState(base=torch.ones(4, 8), delta_base=torch.full((4, 8), 2.0))
    set_slot(layer.k, 2, new)
    assert torch.equal(slot(layer.k, 2).base, new.base)
    assert torch.equal(st.k.base[1, 2], new.base) and torch.equal(st.k.delta_base[1, 2], new.delta_base)
    assert st.k.base[0].abs().sum() == 0 and st.v.base.abs().sum() == 0


@pytest.mark.parametrize("joint", [None, "front", "rear"])
def test_attention_strategies_match_jax(joint):
    """SingleDeviceAttn and SimRingAttn (ring 2: a WARMUP call, then a
    BINARY call against the carried EF state), optionally with joint text
    K/V, on the same inputs.  fp32 on both sides; bound as above."""
    import jax

    from compactfusion_tpu.models import attn_impl as jattn
    from compactfusion_tpu_torch.models import attn_impl as tattn

    rng = np.random.default_rng(11)
    b, s, h, d, sj = 2, 8, 2, 16, 3
    steps = [[rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]
             for _ in range(2)]
    jk = rng.standard_normal((b, sj, h, d)).astype(np.float32)
    jv = rng.standard_normal((b, sj, h, d)).astype(np.float32)
    jkw = {} if joint is None else dict(joint_k=jnp.asarray(jk), joint_v=jnp.asarray(jv),
                                       joint_strategy=joint)
    tkw = {} if joint is None else dict(joint_k=torch.from_numpy(jk), joint_v=torch.from_numpy(jv),
                                       joint_strategy=joint)

    q, k, v = steps[0]
    if joint in (None, "front"):
        jkw1 = {} if joint is None else dict(joint_q=jnp.asarray(jk), **jkw)
        tkw1 = {} if joint is None else dict(joint_q=torch.from_numpy(jk), **tkw)
        ref, _ = jattn.SingleDeviceAttn()(*map(jnp.asarray, (q, k, v)), (), **jkw1)
        out, _ = tattn.SingleDeviceAttn()(*map(torch.from_numpy, (q, k, v)), (), **tkw1)
        assert _rel(out.numpy(), ref) <= REL

    jcfg = jconfig.CompactConfig(enabled=True, warmup_steps=1)
    tcfg = tconfig.CompactConfig(enabled=True, warmup_steps=1)
    jst = jax.tree_util.tree_map(lambda a: a[0], jattn.SimRingAttn(
        jcfg, jconfig.CompressType.WARMUP, 2).init_state(1, b, s, h, d, jnp.float32))
    tst = tattn.SimRingAttn(tcfg, tconfig.CompressType.WARMUP, 2).init_state(
        1, b, s, h, d, torch.float32)
    tst = type(tst)(*(type(e)(*(None if a is None else a[0] for a in e)) for e in tst))
    for step, (q, k, v) in enumerate(steps):
        jm, tm = jcfg.type_at(0, step), tcfg.type_at(0, step)
        ref, jst = jattn.SimRingAttn(jcfg, jm, 2)(*map(jnp.asarray, (q, k, v)), jst, **jkw)
        out, tst = tattn.SimRingAttn(tcfg, tm, 2)(*map(torch.from_numpy, (q, k, v)), tst, **tkw)
        assert _rel(out.numpy(), ref) <= REL, step
        assert _rel(tst.k.base.numpy(), jst.k.base) <= REL
        assert _rel(tst.v.base.numpy(), jst.v.base) <= REL
    # the log_stats taps record and leave the output as it was
    from compactfusion_tpu_torch.compact.stats import StatsLogger

    StatsLogger.reset()
    again = tree_map(torch.clone, tst)
    logged, _ = tattn.SimRingAttn(dataclasses.replace(tcfg, log_stats=True), tm, 2)(
        *map(torch.from_numpy, (q, k, v)), again)
    plain, _ = tattn.SimRingAttn(tcfg, tm, 2)(*map(torch.from_numpy, (q, k, v)), tree_map(torch.clone, tst))
    assert torch.equal(logged, plain) and len(StatsLogger.instance().records["k"]) == 2


def _tree_np(state):
    """An EF state as numpy leaves, Int8Payload entries decoded to fp32."""
    out = []
    for e in state:
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):  # Int8Payload: q * scale + min
            q, scale, mn = (_np(f) for f in e)
            out.append(q.astype(np.float32) * scale + mn)
        else:
            out.append(_np(e))
    return out


# (mode, codec, residual, comp_rank); bounds as test_ef_sequence_matches_jax,
# 1e-4 for the low-rank codecs (test_torch_lowrank.py)
MODES = [
    ("quantized", "binary", 1, -1), ("quantized", "int2", 1, -1), ("quantized", "binary", 2, -1),
    ("quantized", "low-rank", 1, 2), ("quantized", "sparse", 1, -1),
    ("simulate", "binary", 1, 2), ("simulate", "int2", 0, -1), ("simulate", "int2", 1, -1),
    ("simulate", "int2", 2, -1), ("simulate", "int2-minmax", 1, -1), ("simulate", "int4", 1, -1),
    ("simulate", "int8", 1, -1), ("simulate", "low-rank", 1, 2), ("simulate", "low-rank-awl", 1, 2),
    ("simulate", "low-rank-int4", 2, 2), ("simulate", "sparse", 1, -1),
]


@pytest.mark.parametrize("mode,codec,residual,rank", MODES)
def test_ef_modes_match_jax(mode, codec, residual, rank, monkeypatch):
    """int8-quantized caches and ``simulate`` mode over 2 WARMUP + 3 codec
    steps: payloads (dense in simulate mode), reconstructions and states
    agree with the JAX engine, and the receiver's state equals the
    sender's leaf for leaf."""
    from tests.test_torch_lowrank import use_jax_init_q

    use_jax_init_q(monkeypatch)
    rel = 1e-4 if codec.startswith("low-rank") or rank > 0 else REL
    kw = dict(enabled=True, warmup_steps=2, residual=residual, error_feedback=residual != 0,
              comp_rank=rank, quantized_cache=mode == "quantized", simulate=mode == "simulate")
    jcfg = jconfig.CompactConfig(compress_type=jconfig.CompressType(codec), **kw)
    tcfg = tconfig.CompactConfig(compress_type=tconfig.CompressType(codec), **kw)
    jst = jengine.init_ef_state((N, C), jnp.float32, residual, quantized=kw["quantized_cache"])
    tst = tengine.init_ef_state((N, C), torch.float32, residual, quantized=kw["quantized_cache"])
    trecv = tst
    rng = np.random.default_rng(len(codec) + residual)
    awl = (rng.random(N) + 0.5).astype(np.float32) if codec == "low-rank-awl" else None
    x = rng.standard_normal((N, C)).astype(np.float32)
    for step in range(5):
        x = x + 0.1 * rng.standard_normal((N, C)).astype(np.float32)
        jm, tm = jcfg.type_at(0, step), tcfg.type_at(0, step)
        jpay, jst_new = jengine.ef_compress(jnp.asarray(x), jst, jcfg, jm,
                                            awl_scale=None if awl is None else jnp.asarray(awl))
        jhat, _ = jengine.ef_decompress(jpay, jst, jcfg, jm)
        tpay, tst_new = tengine.ef_compress(torch.from_numpy(x), tst, tcfg, tm,
                                            awl_scale=None if awl is None else torch.from_numpy(awl))
        that, trecv = tengine.ef_decompress(tpay, trecv, tcfg, tm)
        if isinstance(tpay, torch.Tensor):
            assert _rel(_np(tpay), _np(jpay)) <= rel, step
        assert _rel(_np(that), _np(jhat)) <= rel, step
        for t, j in zip(_tree_np(tst_new), _tree_np(jst_new)):
            assert (t is None) == (j is None)
            if t is not None:
                assert _rel(t, j) <= rel, step
        for t, r in zip(ring_leaves(tst_new), ring_leaves(trecv)):
            assert torch.equal(t, r)
        jst, tst = jst_new, tst_new


def ring_leaves(tree):
    """Tensor leaves of a state tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree if t is not None for leaf in ring_leaves(t)]


def test_quantized_ring_state_slots():
    """Quantized ring caches: every slot starts as the JAX package's
    int8-coded zero cache, and slots update in place leaf by leaf."""
    jst = jengine.init_ef_state((4, 8), jnp.float32, 2, quantized=True)
    st = init_ring_state(3, 4, 8, torch.float32, residual=2, quantized=True, layers=2)
    assert isinstance(st.k.base, tcodecs.Int8Payload) and st.k.base.q.shape == (2, 3, 4, 8)
    assert st.v.delta_base.scale.shape == (2, 3, 1, 8)
    for t, j in zip(st.k.base, jst.base):
        np.testing.assert_array_equal(_np(t[1, 2]), _np(j))
    layer = tengine.EFState(*(tcodecs.Int8Payload(*(a[1] for a in e)) for e in st.k))
    new = tengine._requant_state(tengine.EFState(base=torch.ones(4, 8), delta_base=torch.eye(4, 8)))
    set_slot(layer, 2, new)
    for t, n in zip(ring_leaves(slot(layer, 2)), ring_leaves(new)):
        assert torch.equal(t, n)
    assert torch.equal(st.k.base.q[1, 2], new.base.q) and st.k.base.q[0].sum() == 0


@pytest.mark.parametrize("shape,dtype", [((2, 17550, 24), torch.float32), ((3, 5), torch.bfloat16),
                                         ((7,), torch.int8)])
def test_bits_digest_tells_copies_apart(shape, dtype):
    """``check_consistency`` skips its all-reduce when every rank's
    ``bits_digest`` is equal: equal bits give equal digests, and a change of
    any one element (a flipped bit of it, anywhere) changes the digest."""
    from compactfusion_tpu_torch.compact.engine import bits_digest

    g = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=g) * 50).to(dtype)
    d = bits_digest(x)
    assert d.shape == (2,) and d.dtype == torch.int64
    assert torch.equal(bits_digest(x.clone()), d)
    flat = x.reshape(-1).view(torch.uint8)
    for pos in (0, flat.numel() // 2, flat.numel() - 1):
        for bit in (0, 7):
            y = flat.clone()
            y[pos] ^= 1 << bit
            assert not torch.equal(bits_digest(y.view(dtype).reshape(shape)), d), (pos, bit)
    # two elements swapped: the position weights see it
    if x.numel() > 1 and not torch.equal(x.reshape(-1)[0], x.reshape(-1)[-1]):
        y = x.reshape(-1).clone()
        y[0], y[-1] = x.reshape(-1)[-1], x.reshape(-1)[0]
        assert not torch.equal(bits_digest(y.reshape(shape)), d)
