"""Port's codecs and sub-byte packers vs the JAX package, on the CPU.

The same numpy inputs go through ``compactfusion_tpu.compact.codecs`` and
``compactfusion_tpu_torch.compact.codecs``.  Bounds and why:

* packed codes and sparse indices: equal (same fp32 comparisons and
  roundings on the same values);
* bf16 scale fields: within one bf16 ulp (means and min/max-derived scales
  in fp32, summed in another order, may cross a bf16 rounding boundary);
* decoded tensors: 1e-6 relative, elementwise; the port decodes the JAX
  payload, so only the fp32 matmul order of a rank-k scale differs;
* ``sim_*`` outputs: 1e-6 relative (Frobenius), the same fp32 arithmetic;
* low-rank products (LOW_RANK, AWL, LOW_RANK_Q, rank-k BINARY scales):
  1e-4 relative (Frobenius), with the JAX start basis handed to the port
  (see test_torch_lowrank.py) and QR sums in another order; LOW_RANK_Q
  then quantizes U and V to 4 bits, where a factor within rounding of a
  code boundary could move one code (on these inputs none does).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compactfusion_tpu.compact import codecs as jcodecs
from compactfusion_tpu.compact import packing as jpacking
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu_torch.compact import codecs as tcodecs
from compactfusion_tpu_torch.compact import packing as tpacking
from compactfusion_tpu_torch.config import CompressType as TType
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from tests.helpers import rel_err
from tests.test_torch_lowrank import use_jax_init_q

REL = 1e-6
LOWRANK_REL = 1e-4
N, C = 64, 128

LOW_RANK = ("low-rank", "low-rank-awl", "low-rank-int4")
# (method value, rank); the rank only matters to BINARY and the low-rank codecs
CASES = [("binary", -1), ("binary", 2), ("int2", -1), ("int2-minmax", -1), ("int4", -1),
         ("int8", -1), ("low-rank", 2), ("low-rank", 4), ("low-rank-awl", 2),
         ("low-rank-int4", 2), ("sparse", -1)]


def _to_torch(payload):
    """A JAX payload (NamedTuple of arrays, possibly nested) as the port's."""
    if isinstance(payload, tuple):
        return getattr(tcodecs, type(payload).__name__)(*(_to_torch(f) for f in payload))
    return params_from_numpy(np.asarray(payload))


def _leaves(payload):
    if isinstance(payload, tuple):
        return [leaf for f in payload for leaf in _leaves(f)]
    return [payload]


def _bf16_ulp(a):
    a = np.abs(np.asarray(a, np.float32))
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (exp - 7)


def _data(seed=0):
    """Temporally-coherent-looking deltas: per-channel scales, exact zeros,
    and a sparse group with tied magnitudes (ties go to the first index)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, C)) * rng.uniform(0.2, 2.0, (1, C))).astype(np.float32)
    x[0, :4] = 0.0
    x[1, :8] = [0.5, -0.5, 0.5, 0.25, 0.0, -0.5, 0.1, 0.5]
    awl = (rng.random(N) + 0.5).astype(np.float32)
    return x, awl


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packers_match_jax(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (37, 1152)).astype(np.uint8)
    jpack, junpack = {1: (jpacking.pack_bits, jpacking.unpack_bits),
                      2: (jpacking.pack_2bit, jpacking.unpack_2bit),
                      4: (jpacking.pack_4bit, jpacking.unpack_4bit)}[bits]
    tpack, tunpack = {1: (tpacking.pack_bits, tpacking.unpack_bits),
                      2: (tpacking.pack_2bit, tpacking.unpack_2bit),
                      4: (tpacking.pack_4bit, tpacking.unpack_4bit)}[bits]
    jp = np.asarray(jpack(jnp.asarray(codes)))
    tp = tpack(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8 and tp.shape == (37, 1152 * bits // 8)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tunpack(tp).numpy(), codes)
    np.testing.assert_array_equal(np.asarray(junpack(jnp.asarray(jp))), codes)
    with pytest.raises(ValueError):
        tpack(torch.zeros((2, {1: 12, 2: 6, 4: 3}[bits]), dtype=torch.uint8))


@pytest.mark.parametrize("method,rank", CASES)
def test_encode_decode_sim_match_jax(method, rank, monkeypatch):
    use_jax_init_q(monkeypatch)
    x, awl = _data()
    jm, tm = JType(method), TType(method)
    awl_kw = method == "low-rank-awl"
    jp = jcodecs.encode(jnp.asarray(x), jm, rank=rank,
                        awl_scale=jnp.asarray(awl) if awl_kw else None)
    tp = tcodecs.encode(torch.from_numpy(x), tm, rank=rank,
                        awl_scale=torch.from_numpy(awl) if awl_kw else None)
    assert type(tp).__name__ == type(jp).__name__
    assert tcodecs.payload_nbytes(tp) == jcodecs.payload_nbytes(jp)
    # every field is a row-major buffer, as a send and the quant kernels need
    assert all(leaf.is_contiguous() for leaf in _leaves(tp))

    jdec = np.asarray(jcodecs.decode(jp, jm))
    tdec = tcodecs.decode(tp, tm)
    assert tdec.dtype == torch.float32 and tdec.shape == (N, C)
    jsim = np.asarray(jcodecs.sim_roundtrip(jnp.asarray(x), jm, rank=rank,
                                            awl_scale=jnp.asarray(awl) if awl_kw else None))
    tsim = tcodecs.sim_roundtrip(torch.from_numpy(x), tm, rank=rank,
                                 awl_scale=torch.from_numpy(awl) if awl_kw else None)
    if method in LOW_RANK or rank > 0:
        # factors may differ by QR column signs: compare what they decode to
        assert rel_err(tdec.numpy(), jdec) < LOWRANK_REL
        assert rel_err(tsim.numpy(), jsim) < LOWRANK_REL
        if method == "binary":
            np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
        return
    for t, j in zip(_leaves(tp), _leaves(jp)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.uint8:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert t.dtype == torch.bfloat16
            j32 = j.astype(np.float32)
            assert np.all(np.abs(t.float().numpy() - j32) <= _bf16_ulp(j32))
    # the port decodes the JAX payload: same wire format
    dec = tcodecs.decode(_to_torch(jp), tm).numpy()
    np.testing.assert_allclose(dec, jdec, rtol=REL, atol=0)
    assert rel_err(tdec.numpy(), jdec) < REL
    assert rel_err(tsim.numpy(), jsim) < REL
    assert tsim.dtype == torch.float32


def test_sim_keeps_dtype_and_sparse_ties_go_first():
    x, _ = _data(1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for m in TType:
        if m in (TType.WARMUP, TType.IDENTITY):
            continue
        rank = 2 if m.value.startswith("low-rank") or m == TType.BINARY else -1
        out = tcodecs.sim_roundtrip(xb, m, rank=rank)
        assert out.dtype == torch.bfloat16 and out.shape == (N, C) and torch.isfinite(out.float()).all()
    p = tcodecs.encode_sparse(torch.from_numpy(x), 8)
    assert p.indices[1, 0] == 0 and float(p.values[1, 0]) == 0.5
    assert p.values.shape == (N, C // 8) and p.indices.dtype == torch.uint8


def test_int2_codes_threshold_on_fp32_scale():
    """``encode_int2`` and ``sim_int2`` decide codes on the unrounded fp32
    scale and reconstruct with the wire-rounded one, as the JAX codec does."""
    x, _ = _data(2)
    tx = torch.from_numpy(x)
    u, v = tcodecs._mean_scale_uv(tx)
    s = u * v
    codes = tpacking.unpack_2bit(tcodecs.encode_int2(tx).packed)
    expect = 2 * (tx >= 0).to(torch.uint8) + torch.where(tx >= 0, tx > s, tx < -s).to(torch.uint8)
    assert torch.equal(codes, expect)
    s_wire = tcodecs._wire(u).float() * tcodecs._wire(v).float()
    assert torch.equal(tcodecs.sim_int2(tx), tcodecs._int2_values(expect, s_wire))


def test_minmax_constant_channel_and_int8_minimum():
    """eps sits on the range, so the all-zeros cache and any constant channel
    decode exactly; INT8 stores the channel minimum (no zero point)."""
    x = np.zeros((16, 32), np.float32)
    x[:, 1] = 3.25  # constant channel, large offset
    x[:, 2] = np.linspace(-1, 1, 16)
    jp = jcodecs.encode_int8(jnp.asarray(x))
    tp = tcodecs.encode_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
    np.testing.assert_array_equal(tp.minv.float().numpy(), np.asarray(jp.minv, np.float32))
    dec = tcodecs.decode_int8(tp).numpy()
    np.testing.assert_array_equal(dec[:, :2], x[:, :2])
    for enc, dec_fn in ((tcodecs.encode_int4, tcodecs.decode_int4),
                        (tcodecs.encode_int2_minmax, tcodecs.decode_int2_minmax)):
        np.testing.assert_array_equal(dec_fn(enc(torch.from_numpy(x))).numpy()[:, :2], x[:, :2])
    with pytest.raises(ValueError):
        tcodecs.encode(torch.from_numpy(x), "int3")


def test_awl_row_scale_matches_jax():
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((N, C)) * rng.uniform(0.1, 3.0, (N, 1))).astype(ml_dtypes.bfloat16)
    j = np.asarray(jcodecs.awl_row_scale(jnp.asarray(v)))
    t = tcodecs.awl_row_scale(params_from_numpy(v))
    assert t.dtype == torch.float32 and t.shape == (N,)
    np.testing.assert_allclose(t.numpy(), j, rtol=REL)
