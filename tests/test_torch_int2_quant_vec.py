"""Kernel 5, INT2 quant: its launch plan and its vector thread mapping
(``csrc/int2_quant.cu``) on the CPU.

``ops/quant.py::quant_plan(4, base, v, x=x)`` picks the vector kernel (4
packed bytes per thread) or the scalar one before the launch, by the rule
of kernels 2, 3 and 6.  The kernel runs only on the card, so its mapping of
threads to (row, bytes) and its arithmetic are modelled here in torch and
held against the JAX ``int2_quant_fastpath`` in Pallas interpret mode
(packed bytes exact, new base within 1e-6 relative, the ``REL`` of
``tests/test_torch_quant.py``), against the port's twin bit for bit, and
against kernel 6's models on both plans (the error-feedback invariant:
every quant plan into every dequant plan rebuilds the same base).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.ops import quant_pallas as jqp
from compactfusion_tpu_torch.compact.packing import pack_2bit, unpack_2bit
from compactfusion_tpu_torch.ops import quant as tqp
from compactfusion_tpu_torch.utils.prof import Profiler
from tests.test_torch_dequant_vec import VEC, _FakeLib, _int2_data, _torch, dequant_model
from tests.test_torch_quant_vec import REL

REPO = Path(__file__).resolve().parent.parent


def int2_quant_model(x, base, u, v, vec):
    """The INT2 quant kernel of ``vec`` packed bytes per thread (1: the
    scalar kernel) in torch: thread t takes row n = t // (G / vec) and
    bytes j..j+vec-1, j = (t % (G / vec)) * vec; its channels are i*G + j +
    e for crumb group i and byte e; the scale is summed k ascending from 0;
    code = 2 * (delta >= 0) + (delta > s or delta < -s) goes to bits 8e +
    2i of the thread's word; new base = base + sign * {0.5, 2} * s."""
    n_rows, c = x.shape
    g = c // 4
    per_row = g // vec
    t = torch.arange(n_rows * per_row)
    n, j = t // per_row, (t % per_row) * vec
    e = torch.arange(vec)[None, None, :]
    i = torch.arange(4)[None, :, None]
    ch = i * g + j[:, None, None] + e
    rows = n[:, None, None].expand_as(ch)
    seen = torch.zeros((n_rows, c), dtype=torch.int64)
    seen.index_put_((rows.reshape(-1), ch.reshape(-1)), torch.ones(ch.numel(), dtype=torch.int64),
                    accumulate=True)
    assert (seen == 1).all(), "every channel of every row is one thread's"
    xs, bs = x.float()[rows, ch], base.float()[rows, ch]
    sc = torch.zeros_like(xs)
    for kk in range(u.shape[1]):
        sc = sc + u.float()[rows, kk] * v.float()[kk][ch]
    delta = xs - bs
    pos, mag = delta >= 0, (delta > sc) | (delta < -sc)
    code = 2 * pos.to(torch.int64) + mag.to(torch.int64)
    word = (code << (8 * e + 2 * i)).sum(dim=1)  # (threads, vec): each byte's 4 crumbs, one word
    packed = torch.zeros((n_rows, g), dtype=torch.uint8)
    packed[n[:, None], j[:, None] + torch.arange(vec)[None, :]] = (word >> (8 * e[0])).to(torch.uint8)
    new_base = torch.empty_like(base)
    new_base[rows, ch] = (bs + torch.where(pos, 1.0, -1.0) * torch.where(mag, 2.0, 0.5) * sc).to(base.dtype)
    return packed, new_base


@pytest.mark.parametrize("c,vec", [(1152, VEC), (64, VEC), (1160, 1), (1144, 1)])
def test_int2_quant_plan(c, vec):
    """The vector kernel where C/4 is a multiple of 4 (C1152: 288 bytes a
    row; C64: 16), the scalar one where it is not (C1160: 290; C1144: 286),
    on fp32 and bf16 operands alike."""
    x = torch.zeros(256, c)
    v = torch.zeros(1, c, dtype=torch.bfloat16)
    assert tqp.quant_plan(4, x, v, x=x) == vec
    assert tqp.quant_plan(4, x.bfloat16(), v, x=x.bfloat16()) == vec


def test_int2_quant_plan_takes_the_scalar_kernel_on_misaligned_views():
    """An x or base view that starts 4 bytes into its storage takes the
    scalar kernel: the vector kernel's 16-byte accesses need 16-byte
    aligned starts."""
    x = torch.zeros(256, 1152)
    v = torch.zeros(1, 1152, dtype=torch.bfloat16)
    off = torch.zeros(256 * 1152 + 1)[1:].view(256, 1152)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert tqp.quant_plan(4, x, v, x=x) == VEC
    assert tqp.quant_plan(4, x, v, x=off) == 1
    assert tqp.quant_plan(4, off, v, x=x) == 1


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,c", [(100, 64), (256, 1152), (256, 1160)])
def test_vector_mapping_matches_jax_the_twin_and_both_dequants(n, c, k):
    x, base, u, v = _int2_data(n, c, k, seed=n + c + k)
    tx, tb, tu, tv = _torch(x, base, u, v, torch.float32)
    vec = tqp.quant_plan(4, tb, tv, x=tx)
    assert vec == (1 if c == 1160 else VEC)
    packed, new_base = int2_quant_model(tx, tb, tu, tv, vec)
    assert set(unpack_2bit(packed).unique().tolist()) == {0, 1, 2, 3}
    jpacked, jnew = jqp.int2_quant_fastpath(*map(jnp.asarray, (x, base, u, v)), interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    jnew = np.asarray(jnew, np.float64)
    assert np.max(np.abs(new_base.numpy() - jnew) / np.maximum(np.abs(jnew), 1e-30)) <= REL
    twin_packed, twin_base = tqp.int2_quant_fastpath_ref(tx, tb, tu, tv)
    assert torch.equal(packed, twin_packed) and torch.equal(new_base, twin_base)
    for p in {1, vec}:  # both quant plans into both dequant plans
        qp, qb = int2_quant_model(tx, tb, tu, tv, p)
        assert torch.equal(qp, packed) and torch.equal(qb, new_base)
        for dp in {1, vec}:
            assert torch.equal(dequant_model("int2", qp, tb, tu, tv, dp), new_base)


@pytest.mark.parametrize("vec", [1, VEC])
def test_vector_mapping_on_bf16_bases(vec):
    """bf16 x and base: the 8-byte accesses round the new base once, as the
    twin does; the crumbs are ``pack_2bit``'s grouped layout."""
    tx, tb, tu, tv = _torch(*_int2_data(64, 256, 2, seed=7), torch.bfloat16)
    packed, new_base = int2_quant_model(tx, tb, tu, tv, vec)
    twin_packed, twin_base = tqp.int2_quant_fastpath_ref(tx, tb, tu, tv)
    assert new_base.dtype == torch.bfloat16
    assert torch.equal(packed, twin_packed) and torch.equal(new_base, twin_base)
    delta = tx.float() - tb.float()
    s = tu.float() @ tv.float()
    codes = 2 * (delta >= 0).to(torch.uint8) + ((delta > s) | (delta < -s)).to(torch.uint8)
    assert torch.equal(packed, pack_2bit(codes))


@pytest.mark.parametrize("c,plan", [(64, VEC), (1160, 1)])
def test_int2_quant_wrapper_hands_the_entry_its_plan_and_counts_it(c, plan, monkeypatch):
    """On a CUDA tensor the wrapper passes ``cf_int2_quant`` its arguments in
    the order ``ops/_build.py`` declares them, the plan just before the
    stream, and counts the launch (on the vector plan also in
    ``vec_launches``); when the entry refuses the plan, it raises (no retry
    on another plan).  Here the library is a stand-in that records its
    calls, and the tensors report themselves as CUDA."""
    from compactfusion_tpu_torch.ops import _build
    from tests.test_torch_compact_ring import _declared_argtypes

    x, base = torch.zeros(8, c), torch.zeros(8, c)
    u, v = torch.ones(8, 1, dtype=torch.bfloat16), torch.ones(1, c, dtype=torch.bfloat16)
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tqp, "_stream", lambda t: 7)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    Profiler.reset()
    packed, new_base = tqp.int2_quant_fastpath(x, base, u, v)
    ((name, args),) = lib.calls
    assert name == "cf_int2_quant" and len(args) == len(_declared_argtypes(name))
    assert args[:6] == (x.data_ptr(), base.data_ptr(), u.data_ptr(), v.data_ptr(), packed.data_ptr(),
                        new_base.data_ptr())
    assert args[6:] == (8, c, 1, 0, 0, plan, 7)
    assert Profiler.counter("int2_quant_fastpath.launches") == 1
    assert Profiler.counter("int2_quant_fastpath.vec_launches") == (1 if plan > 1 else 0)
    refused = _FakeLib(status=1)
    monkeypatch.setattr(_build, "load", lambda: refused)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tqp.int2_quant_fastpath(x, base, u, v)
    assert len(refused.calls) == 1 and Profiler.counter("int2_quant_fastpath.launches") == 1


def test_chip_smoke_expects_every_int2_quant_launch_on_the_vector_plan():
    """``chip_smoke.py`` counts kernel 5's vector-plan launches apart and
    expects all of the path's there (C1152, aligned chunks), as for kernels
    2, 3 and 6."""
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert ("int2_quant_fastpath", "vec_launches") in smoke.ROUTES
    key = smoke.VEC["int2_quant_fastpath"]
    assert set(smoke.VEC) == {"binary_quant_fastpath", "binary_dequant_fastpath", "int2_quant_fastpath",
                              "int2_dequant_fastpath"}
    expect = smoke._with_routes({"int2_quant_fastpath": 13 * 256, "int2_dequant_fastpath": 13 * 256})
    assert expect[key] == 13 * 256 and expect[smoke.VEC["binary_quant_fastpath"]] == 0
