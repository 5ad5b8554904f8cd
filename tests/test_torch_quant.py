"""Port's 1-bit and 2-bit quant twins, binary codec and packing vs the JAX
package.

The JAX side runs ``binary_quant_fastpath`` / ``binary_dequant_fastpath``
and the INT2 pair in Pallas interpret mode, as tests/compact/test_fastpath.py
does.  Packed
bytes must match exactly.  New bases agree to 1e-6 relative: fp32
arithmetic on the same values, where only the order of the K-term scale
sum may differ (K=1 is a single exact product of bf16 values).  Scale
factors from ``encode_binary`` agree within one bf16 ulp: the fp32 means
are summed in another order, which can move a value across a bf16
rounding boundary.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compactfusion_tpu.compact import codecs as jcodecs
from compactfusion_tpu.compact import packing as jpacking
from compactfusion_tpu.ops import quant_pallas as jqp
from compactfusion_tpu_torch.compact import codecs as tcodecs
from compactfusion_tpu_torch.compact import packing as tpacking
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.ops import quant as tqp

REL = 1e-6


def _bf16(a):
    """numpy -> bf16 numpy (ml_dtypes), the wire dtype of u and v."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _data(n, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    base = (rng.standard_normal((n, c)) * 0.9).astype(np.float32)
    x[0, :8] = base[0, :8]  # delta == 0 exactly maps to +1
    u = _bf16(rng.random((n, k)) + 0.5)
    v = _bf16(rng.random((k, c)) * 0.3)
    return x, base, u, v


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("c", [64, 1152])
@pytest.mark.parametrize("n", [100, 256])
def test_quant_dequant_twins_match_jax_kernels(n, c, k):
    x, base, u, v = _data(n, c, k, seed=n + c + k)
    jpacked, jnew = jqp.binary_quant_fastpath(
        jnp.asarray(x), jnp.asarray(base), jnp.asarray(u), jnp.asarray(v), interpret=True)
    tx, tb = torch.from_numpy(x), torch.from_numpy(base)
    tu, tv = params_from_numpy(u), params_from_numpy(v)
    packed, new_base = tqp.binary_quant_fastpath(tx, tb, tu, tv)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert _rel(new_base.numpy(), jnew) <= REL

    jhat = jqp.binary_dequant_fastpath(jpacked, jnp.asarray(base), jnp.asarray(u),
                                       jnp.asarray(v), interpret=True)
    x_hat = tqp.binary_dequant_fastpath(packed, tb, tu, tv)
    assert _rel(x_hat.numpy(), jhat) <= REL
    # the EF consistency invariant inside the port: dequant rebuilds the
    # sender's new base bit for bit
    assert torch.equal(x_hat, new_base)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("c", [64, 1152])
@pytest.mark.parametrize("n", [100, 256])
def test_int2_twins_match_jax_kernels(n, c, k):
    """INT2 twins vs ``int2_quant_fastpath`` / ``int2_dequant_fastpath`` in
    Pallas interpret mode; bounds as for the binary pair (module doc)."""
    x, base, u, v = _data(n, c, k, seed=n + c + k + 1)
    s = np.asarray(u, np.float32) @ np.asarray(v, np.float32)
    x[1, :8] = base[1, :8] + s[1, :8]  # delta at +-s, up to rounding: the
    x[2, :8] = base[2, :8] - s[2, :8]  # threshold compare decides the level
    jpacked, jnew = jqp.int2_quant_fastpath(
        jnp.asarray(x), jnp.asarray(base), jnp.asarray(u), jnp.asarray(v), interpret=True)
    tb = torch.from_numpy(base)
    tu, tv = params_from_numpy(u), params_from_numpy(v)
    packed, new_base = tqp.int2_quant_fastpath(torch.from_numpy(x), tb, tu, tv)
    assert packed.shape == (n, c // 4)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert _rel(new_base.numpy(), jnew) <= REL
    jhat = jqp.int2_dequant_fastpath(jpacked, jnp.asarray(base), jnp.asarray(u), jnp.asarray(v),
                                     interpret=True)
    x_hat = tqp.int2_dequant_fastpath(packed, tb, tu, tv)
    assert _rel(x_hat.numpy(), jhat) <= REL
    assert torch.equal(x_hat, new_base)


def test_bf16_base_kept_in_bf16():
    x, base, u, v = _data(32, 64, 1, seed=3)
    tb = torch.from_numpy(base).to(torch.bfloat16)
    tu, tv = params_from_numpy(u), params_from_numpy(v)
    for quant, dequant in ((tqp.binary_quant_fastpath, tqp.binary_dequant_fastpath),
                           (tqp.int2_quant_fastpath, tqp.int2_dequant_fastpath)):
        packed, new_base = quant(torch.from_numpy(x), tb, tu, tv)
        assert new_base.dtype == torch.bfloat16
        assert torch.equal(dequant(packed, tb, tu, tv), new_base)


def _bf16_ulp(a):
    a = np.abs(np.asarray(a, np.float32))
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (exp - 7)


@pytest.mark.parametrize("n,c", [(100, 64), (256, 1152)])
def test_encode_decode_binary_match_jax(n, c):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, c)).astype(np.float32)
    x[1, 3] = -0.0
    jp = jcodecs.encode_binary(jnp.asarray(x), -1)
    tp = tcodecs.encode_binary(torch.from_numpy(x), -1)
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
    for t, j in ((tp.scale_u, jp.scale_u), (tp.scale_v, jp.scale_v)):
        assert t.dtype == torch.bfloat16
        t32 = t.float().numpy()
        j32 = np.asarray(j, np.float32)
        assert np.all(np.abs(t32 - j32) <= _bf16_ulp(j32))
    # decode the JAX payload with the port's decoder: same wire format
    jpay = tcodecs.BinaryPayload(*(params_from_numpy(np.asarray(f)) for f in jp))
    dec = tcodecs.decode_binary(jpay)
    ref = jcodecs.decode_binary(jp)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), rtol=REL, atol=0)


def test_pack_unpack_bytes_match_jax():
    rng = np.random.default_rng(0)
    bits = (rng.random((37, 1152)) > 0.5).astype(np.uint8)
    jpacked = np.asarray(jpacking.pack_bits(jnp.asarray(bits)))
    tpacked = tpacking.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    np.testing.assert_array_equal(tpacking.unpack_bits(tpacked).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jpacking.unpack_bits(jnp.asarray(jpacked))), bits)
    with pytest.raises(ValueError):
        tpacking.pack_bits(torch.zeros((2, 12), dtype=torch.uint8))


def test_rank_scale_and_other_codecs_raise():
    """The rank-k scale, every codec and the banded flash branch
    (``window=``, DiTFastAttn's kernel) are ported; the banded branch
    refuses ``kv_lens``, and the quant wrappers reject what their kernels do
    not take."""
    from compactfusion_tpu_torch.ops import flash

    x = torch.randn(16, 64)
    assert tcodecs.encode_binary(x, rank=4).scale_u.shape == (16, 4)
    assert isinstance(tcodecs.encode(x, tcodecs.CompressType.INT2), tcodecs.Int2Payload)
    q = torch.randn(1, 8, 2, 16)
    assert torch.equal(flash.flash_attn_with_lse(q, q, q, window=2)[0],
                       flash.flash_attn_window_with_lse_ref(q, q, q, 2)[0])
    with pytest.raises(ValueError):
        flash.flash_attn_with_lse(q, q, q, kv_lens=torch.tensor([8]), window=2)
    u, v = torch.ones(16, 1, dtype=torch.bfloat16), torch.ones(1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # C % 4 != 0, checked before any kernel runs
        tqp._quant_launch("cf_int2_quant", torch.zeros(16, 66), torch.zeros(16, 66), u, v, 4)
    with pytest.raises(TypeError):
        tqp._quant_launch("cf_int2_quant", x, x, u.float(), v, 4)
    with pytest.raises(ValueError):
        tqp._dequant_launch("cf_int2_dequant", torch.zeros(16, 16, dtype=torch.uint8), x.T, u, v, 4)
