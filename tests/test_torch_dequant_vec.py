"""Kernels 3 and 6, binary and INT2 dequant: their launch plan and their
vector thread mapping (``csrc/binary_quant.cu``, ``csrc/int2_quant.cu``) on
the CPU.

``ops/quant.py::quant_plan`` picks the vector kernel (4 packed bytes per
thread) or the scalar one (one thread per byte) before each launch.  The
kernels run only on the card, so their mapping of threads to (row, bytes)
and their arithmetic are modelled here in torch and held against the JAX
``binary_dequant_fastpath`` and ``int2_dequant_fastpath`` in Pallas
interpret mode (within 1e-6 relative, the ``REL`` of
``tests/test_torch_quant.py``), against the port's twins bit for bit, and
against quant's new base bit for bit: from both plans of kernel 2 (binary)
and from kernel 5's twin (INT2), the error-feedback consistency invariant
whichever plan each side ran.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.ops import quant_pallas as jqp
from compactfusion_tpu_torch.compact.packing import unpack_2bit
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.ops import quant as tqp
from tests.test_torch_quant_vec import REL, _data, vec_model

#: channel groups of a packed byte and bits per code: binary, INT2
CODECS = {"binary": (8, 1), "int2": (4, 2)}
VEC = tqp.QUANT_VEC_BYTES


def dequant_model(codec, packed, base, u, v, vec):
    """The dequant kernel of ``vec`` packed bytes per thread (1: the scalar
    kernel) in torch: thread t takes row n = t // (G / vec) and bytes
    j..j+vec-1, j = (t % (G / vec)) * vec (G = C / per_byte, one word of
    the bytes); its channels are i*G + j + e for group i and byte e, whose
    code is bits [bits*i, bits*(i+1)) of byte j + e; the scale is summed
    from 0 with k ascending; out = base + (bit ? s : -s) (binary) or base +
    sign * {0.5, 2} * s (INT2), rounded once to base's dtype."""
    per_byte, bits = CODECS[codec]
    n_rows, g = packed.shape
    c = g * per_byte
    per_row = g // vec
    t = torch.arange(n_rows * per_row)
    n, j = t // per_row, (t % per_row) * vec
    e = torch.arange(vec)[None, None, :]
    i = torch.arange(per_byte)[None, :, None]
    ch = i * g + j[:, None, None] + e
    rows = n[:, None, None].expand_as(ch)
    seen = torch.zeros((n_rows, c), dtype=torch.int64)
    seen.index_put_((rows.reshape(-1), ch.reshape(-1)), torch.ones(ch.numel(), dtype=torch.int64),
                    accumulate=True)
    assert (seen == 1).all(), "every channel of every row is one thread's"
    word = packed.to(torch.int64)[n[:, None], j[:, None] + torch.arange(vec)[None, :]]  # (threads, vec)
    code = (word[:, None, :] >> (bits * i)) & ((1 << bits) - 1)
    bs = base.float()[rows, ch]
    sc = torch.zeros_like(bs)
    for kk in range(u.shape[1]):
        sc = sc + u.float()[rows, kk] * v.float()[kk][ch]
    if codec == "binary":
        val = bs + torch.where(code.bool(), sc, -sc)
    else:
        val = bs + torch.where(code >= 2, 1.0, -1.0) * torch.where((code & 1).bool(), 2.0, 0.5) * sc
    out = torch.empty_like(base)
    out[rows, ch] = val.to(base.dtype)
    return out


def _int2_data(n, c, k, seed):
    """Inputs of an INT2 pair: the mean scale is about |delta|, so all four
    codes occur."""
    x, base, u, v = _data(n, c, k, seed)
    return x, base, u, (v.astype(np.float32) * 3).astype(v.dtype)


def _quant(codec, x, base, u, v, vec):
    """(packed, new base) of quant: kernel 2 on plan ``vec`` (the model of
    ``tests/test_torch_quant_vec.py``), kernel 5 by its twin."""
    if codec == "binary":
        return vec_model(x, base, u, v, vec)
    return tqp.int2_quant_fastpath_ref(x, base, u, v)


def _torch(x, base, u, v, dtype):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(base).to(dtype),
            params_from_numpy(u), params_from_numpy(v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,c", [(100, 64), (256, 1152), (256, 1160)])
@pytest.mark.parametrize("codec", CODECS)
def test_vector_dequant_matches_jax_twin_and_quant(codec, n, c, k, dtype):
    per_byte = CODECS[codec][0]
    make = _data if codec == "binary" else _int2_data
    x, base, u, v = make(n, c, k, seed=n + c + k + per_byte)
    tx, tb, tu, tv = _torch(x, base, u, v, dtype)
    vec = tqp.quant_plan(per_byte, tb, tv, packed=torch.zeros((n, c // per_byte), dtype=torch.uint8))
    # C1160: 145 binary bytes a row, 290 INT2 bytes: neither a multiple of 4
    assert vec == (1 if c == 1160 else VEC)
    quant_plans = (1, VEC) if codec == "binary" and vec > 1 else (1,)
    for qvec in quant_plans:  # every sender plan into both receiver plans
        packed, new_base = _quant(codec, tx, tb, tu, tv, qvec)
        if codec == "int2":
            assert set(unpack_2bit(packed).unique().tolist()) == {0, 1, 2, 3}
        outs = [dequant_model(codec, packed, tb, tu, tv, p) for p in {1, vec}]
        twin = getattr(tqp, f"{codec}_dequant_fastpath_ref")(packed, tb, tu, tv)
        for out in outs:
            assert out.dtype == dtype
            assert torch.equal(out, twin) and torch.equal(out, new_base)
    jbase = jnp.asarray(base).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jout = getattr(jqp, f"{codec}_dequant_fastpath")(jnp.asarray(packed.numpy()), jbase, jnp.asarray(u),
                                                    jnp.asarray(v), interpret=True)
    jout = np.asarray(jout.astype(jnp.float32), np.float64)
    got = outs[-1].double().numpy()
    assert np.max(np.abs(got - jout) / np.maximum(np.abs(jout), 1e-30)) <= REL


@pytest.mark.parametrize("c", [32, 64, 1152, 1160, 1168, 1184])
@pytest.mark.parametrize("codec", CODECS)
def test_dequant_plan_follows_the_packed_bytes_per_row(codec, c):
    """The vector kernel where C/per_byte is a multiple of 4 (binary: C a
    multiple of 32; INT2: of 16), on fp32 and bf16 bases alike; the scalar
    kernel elsewhere."""
    per_byte = CODECS[codec][0]
    want = VEC if (c // per_byte) % VEC == 0 else 1
    v = torch.zeros(1, c, dtype=torch.bfloat16)
    packed = torch.zeros(256, c // per_byte, dtype=torch.uint8)
    for base in (torch.zeros(256, c), torch.zeros(256, c, dtype=torch.bfloat16)):
        assert tqp.quant_plan(per_byte, base, v, packed=packed) == want


@pytest.mark.parametrize("codec", CODECS)
def test_dequant_plan_takes_the_scalar_kernel_on_misaligned_views(codec):
    """Contiguous views that start off the vector kernel's access size take
    the scalar kernel: packed 1 byte in (its 4-byte word), base 4 bytes in
    (16-byte accesses) and v 2 bytes in (8-byte loads)."""
    per_byte = CODECS[codec][0]
    n, c = 256, 1152
    g = c // per_byte
    base, v = torch.zeros(n, c), torch.zeros(1, c, dtype=torch.bfloat16)
    packed = torch.zeros(n, g, dtype=torch.uint8)
    off_packed = torch.zeros(n * g + 1, dtype=torch.uint8)[1:].view(n, g)
    off_base = torch.zeros(n * c + 1)[1:].view(n, c)
    off_v = torch.zeros(c + 1, dtype=torch.bfloat16)[1:].view(1, c)
    assert off_packed.data_ptr() % 4 and off_base.data_ptr() % 16 and off_v.data_ptr() % 8
    assert tqp.quant_plan(per_byte, base, v, packed=packed) == VEC
    assert tqp.quant_plan(per_byte, base, v, packed=off_packed) == 1
    assert tqp.quant_plan(per_byte, off_base, v, packed=packed) == 1
    assert tqp.quant_plan(per_byte, base, off_v, packed=packed) == 1
    # 4 bytes in is enough for packed and 8 for v: their accesses are no wider
    assert tqp.quant_plan(per_byte, base, v, packed=torch.zeros(n * g + 4, dtype=torch.uint8)[4:].view(n, g)) == VEC
    assert tqp.quant_plan(per_byte, base, torch.zeros(c + 4, dtype=torch.bfloat16)[4:].view(1, c),
                          packed=packed) == VEC


@pytest.mark.parametrize("codec", CODECS)
def test_misaligned_base_view_still_rebuilds_the_new_base(codec):
    """A base view 4 bytes into its storage (chip_smoke.py's planted case)
    takes the scalar kernel and still equals quant's new base bit for bit."""
    per_byte = CODECS[codec][0]
    n, c = 64, 256
    make = _data if codec == "binary" else _int2_data
    tx, tb, tu, tv = _torch(*make(n, c, 1, seed=5), torch.float32)
    off = torch.empty(n * c + 1)[1:].view(n, c)
    off.copy_(tb)
    packed, new_base = _quant(codec, tx, tb, tu, tv, VEC if codec == "binary" else 1)
    assert tqp.quant_plan(per_byte, off, tv, packed=packed) == 1
    assert torch.equal(dequant_model(codec, packed, off, tu, tv, 1), new_base)


class _FakeLib:
    """Stands in for the kernel library: records each call of a dequant
    entry and returns ``status``."""

    def __init__(self, status=0):
        self.calls, self.status = [], status

    def __getattr__(self, name):
        if name == "cf_error_string":
            return lambda status: b"invalid argument"
        return lambda *args: self.calls.append((name, args)) or self.status


@pytest.mark.parametrize("codec", CODECS)
def test_dequant_launch_hands_the_entry_its_plan(codec, monkeypatch):
    """The launch passes the C entry its arguments in the order
    ``ops/_build.py`` declares them, the plan just before the stream; when
    the entry refuses the plan, the launch raises (no retry on another
    plan)."""
    from compactfusion_tpu_torch.ops import _build
    from tests.test_torch_compact_ring import _declared_argtypes

    per_byte = CODECS[codec][0]
    entry = f"cf_{codec}_dequant"
    packed = torch.zeros(8, 64 // per_byte, dtype=torch.uint8)
    base, u, v = torch.zeros(8, 64), torch.ones(8, 1, dtype=torch.bfloat16), torch.ones(1, 64, dtype=torch.bfloat16)
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tqp, "_stream", lambda t: 7)
    out = tqp._dequant_launch(entry, packed, base, u, v, per_byte, VEC)
    ((name, args),) = lib.calls
    assert name == entry and out.shape == base.shape and out.dtype == base.dtype
    assert len(args) == len(_declared_argtypes(entry))
    assert args[:5] == (packed.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[5:] == (8, 64, 1, 0, VEC, 7)
    refused = _FakeLib(status=1)
    monkeypatch.setattr(_build, "load", lambda: refused)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tqp._dequant_launch(entry, packed, base, u, v, per_byte, VEC)
    assert len(refused.calls) == 1
