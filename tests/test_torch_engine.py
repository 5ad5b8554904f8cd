"""Port's error-feedback engine vs the JAX package, on a 3-step sequence.

Steps: WARMUP, then BINARY twice, on slowly drifting activations (the
temporal coherence the residual codecs exploit).  Both sides run the codec
path on the CPU.  Packed payloads must match byte for byte; bases and
reconstructions agree to 1e-5 relative: fp32 on both sides, with the bf16
scale factors equal or one bf16 ulp apart (see test_torch_quant.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu import config as jconfig
from compactfusion_tpu.compact import engine as jengine
from compactfusion_tpu_torch import config as tconfig
from compactfusion_tpu_torch.compact import engine as tengine
from compactfusion_tpu_torch.compact.ring import _set_slot, _slot, init_ring_state

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


@pytest.mark.parametrize("residual", [0, 1, 2])
def test_ef_sequence_matches_jax(residual):
    kw = dict(enabled=True, warmup_steps=1, residual=residual, error_feedback=residual != 0)
    jcfg = jconfig.CompactConfig(compress_type=jconfig.CompressType.BINARY, **kw)
    tcfg = tconfig.CompactConfig(compress_type=tconfig.CompressType.BINARY, **kw)
    jst = jengine.init_ef_state((N, C), jnp.float32, residual)
    tst = tengine.init_ef_state((N, C), torch.float32, residual)
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
        assert _rel(that.numpy(), jhat) <= REL
        assert _rel(tst_new.base.numpy(), jst_new.base) <= REL
        if residual == 2:
            assert _rel(tst_new.delta_base.numpy(), jst_new.delta_base) <= REL
        # the receiver's cache equals the sender's, bit for bit
        assert torch.equal(trecv.base, tst_new.base)
        jst, tst = jst_new, tst_new


def test_fastpath_compress_matches_codec_path():
    """The fused path (the kernel's twin on the CPU) gives the codec path's
    payload bytes and base."""
    cfg = tconfig.CompactConfig(enabled=True, warmup_steps=0)
    x0, x1, _ = _steps(seed=7)
    st = tengine.EFState(base=torch.from_numpy(x0), delta_base=None)
    pay_f, st_f = tengine._fastpath_compress(torch.from_numpy(x1), st, cfg, True)
    pay_c, st_c = tengine.ef_compress(torch.from_numpy(x1), st, cfg, tconfig.CompressType.BINARY)
    assert torch.equal(pay_f.packed, pay_c.packed)
    assert torch.equal(pay_f.scale_u, pay_c.scale_u) and torch.equal(pay_f.scale_v, pay_c.scale_v)
    assert _rel(st_f.base.numpy(), st_c.base.numpy()) <= 1e-6
    hat, _ = tengine._fastpath_decompress(pay_f, st, True)
    assert torch.equal(hat, st_f.base)


def test_fastpath_gate():
    cfg = tconfig.CompactConfig(enabled=True)
    B, I2 = tconfig.CompressType.BINARY, tconfig.CompressType.INT2
    assert tengine._use_fastpath(cfg, B, on_cuda=True)
    assert not tengine._use_fastpath(cfg, B, on_cuda=False)
    assert not tengine._use_fastpath(dataclasses.replace(cfg, fastpath=False), B, True)
    assert not tengine._use_fastpath(dataclasses.replace(cfg, residual=2), B, True)
    assert not tengine._use_fastpath(
        dataclasses.replace(cfg, residual=0, error_feedback=False), B, True)
    with pytest.raises(NotImplementedError):
        tengine._use_fastpath(cfg, I2, on_cuda=True)
    with pytest.raises(NotImplementedError):
        tengine.init_ef_state((4, 8), quantized=True)
    with pytest.raises(NotImplementedError):
        tengine.ef_compress(torch.zeros(4, 8), tengine.init_ef_state((4, 8), residual=1),
                            dataclasses.replace(cfg, quantized_cache=True), B)


def test_ring_slots_update_in_place():
    st = init_ring_state(3, 4, 8, torch.float32, residual=2, layers=2)
    assert st.k.base.shape == (2, 3, 4, 8) and st.v.delta_base.shape == (2, 3, 4, 8)
    layer = type(st)(*(type(s)(*(a[1] for a in s)) for s in st))
    new = tengine.EFState(base=torch.ones(4, 8), delta_base=torch.full((4, 8), 2.0))
    _set_slot(layer.k, 2, new)
    assert torch.equal(_slot(layer.k, 2).base, new.base)
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
    with pytest.raises(NotImplementedError):
        tattn.SimRingAttn(dataclasses.replace(tcfg, log_stats=True), tm, 2)(
            *map(torch.from_numpy, (q, k, v)), tst)
