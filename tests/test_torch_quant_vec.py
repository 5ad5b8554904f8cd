"""Kernel 2's launch plan and its vector thread mapping
(``csrc/binary_quant.cu``) on the CPU.

``ops/quant.py::quant_plan`` picks the vector kernel (4 packed bytes per
thread) or the scalar one before the launch, by the rule the dequant
kernels share (``tests/test_torch_dequant_vec.py``).  The kernel itself runs
only on the card, so its mapping of threads to (row, bytes) and its
arithmetic are modelled here in torch and held against the JAX
``binary_quant_fastpath`` in Pallas interpret mode (packed bytes exact, new
base within 1e-6 relative, as ``tests/test_torch_quant.py`` holds the twin)
and against the port's twin bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compactfusion_tpu.ops import quant_pallas as jqp
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.ops import quant as tqp

REL = 1e-6
SRC = Path(__file__).resolve().parent.parent / "compactfusion_tpu_torch" / "csrc" / "quant_common.cuh"


def _data(n, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    base = (rng.standard_normal((n, c)) * 0.9).astype(np.float32)
    x[0, :8] = base[0, :8]  # delta == 0 exactly maps to +1
    x[1, 5] = base[1, 5] = -0.0
    u = (rng.random((n, k)) + 0.5).astype(np.float32).astype(ml_dtypes.bfloat16)
    v = (rng.random((k, c)) * 0.3).astype(np.float32).astype(ml_dtypes.bfloat16)
    return x, base, u, v


def vec_model(x, base, u, v, vec):
    """The quant kernel of ``vec`` packed bytes per thread (1: the scalar
    kernel) in torch: thread t takes row n = t // (G / vec) and bytes
    j..j+vec-1, j = (t % (G / vec)) * vec; its channels are i*G + j + e for
    bit group i and byte e; the scale is summed k ascending from 0, the
    sign is delta >= 0, byte j + e gathers bit i of group i."""
    n_rows, c = x.shape
    g = c // 8
    per_row = g // vec
    t = torch.arange(n_rows * per_row)
    n, j = t // per_row, (t % per_row) * vec
    ch = torch.arange(8)[None, :, None] * g + j[:, None, None] + torch.arange(vec)[None, None, :]
    rows = n[:, None, None].expand_as(ch)
    seen = torch.zeros((n_rows, c), dtype=torch.int64)
    seen.index_put_((rows.reshape(-1), ch.reshape(-1)), torch.ones(ch.numel(), dtype=torch.int64),
                    accumulate=True)
    assert (seen == 1).all(), "every channel of every row is one thread's"
    xs, bs = x.float()[rows, ch], base.float()[rows, ch]
    sc = torch.zeros_like(xs)
    for kk in range(u.shape[1]):
        sc = sc + u.float()[rows, kk] * v.float()[kk][ch]
    pos = xs - bs >= 0
    byte = (pos.to(torch.int32) << torch.arange(8)[None, :, None]).sum(1)  # (threads, vec)
    packed = torch.zeros((n_rows, g), dtype=torch.uint8)
    packed[n[:, None], j[:, None] + torch.arange(vec)[None, :]] = byte.to(torch.uint8)
    new_base = torch.empty_like(base)
    new_base[rows, ch] = (bs + torch.where(pos, sc, -sc)).to(base.dtype)
    return packed, new_base


def test_plan_bytes_follow_the_c_source():
    assert int(re.search(r"constexpr int kVecBytes = (\d+);", SRC.read_text()).group(1)) == tqp.QUANT_VEC_BYTES


@pytest.mark.parametrize("c,vec", [(1152, tqp.QUANT_VEC_BYTES), (64, tqp.QUANT_VEC_BYTES), (1160, 1), (1144, 1)])
def test_binary_quant_plan(c, vec):
    """The vector kernel where C/8 is a multiple of 4 (C=1152: 144 bytes a
    row; C=64: 8), the scalar one where it is not (C=1160: 145; 1144:
    143), on fp32 and bf16 bases alike."""
    x = torch.zeros(256, c)
    v = torch.zeros(1, c, dtype=torch.bfloat16)
    assert tqp.quant_plan(8, x, v, x=x) == vec
    assert tqp.quant_plan(8, x.bfloat16(), v, x=x) == vec


def test_binary_quant_plan_takes_the_scalar_kernel_on_a_misaligned_view():
    """A contiguous view that starts 4 bytes into its storage (x or base)
    or 2 bytes (v) takes the scalar kernel: the vector kernel's 16-byte
    accesses of x and base need 16-byte aligned starts, its 8-byte loads of
    v 8-byte aligned ones."""
    x = torch.zeros(256, 1152)
    v = torch.zeros(1, 1152, dtype=torch.bfloat16)
    off = torch.zeros(256 * 1152 + 1)[1:].view(256, 1152)
    off_v = torch.zeros(1153, dtype=torch.bfloat16)[1:].view(1, 1152)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert tqp.quant_plan(8, x, v, x=x) == tqp.QUANT_VEC_BYTES
    assert tqp.quant_plan(8, x, v, x=off) == 1
    assert tqp.quant_plan(8, off, v, x=x) == 1
    assert tqp.quant_plan(8, x, off_v, x=x) == 1


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,c", [(100, 64), (256, 1152), (256, 1160)])
def test_vector_mapping_matches_jax_and_the_twin(n, c, k):
    x, base, u, v = _data(n, c, k, seed=n + c + k)
    tx, tb = torch.from_numpy(x), torch.from_numpy(base)
    tu, tv = params_from_numpy(u), params_from_numpy(v)
    vec = tqp.quant_plan(8, tb, tv, x=tx)
    assert vec == (1 if c == 1160 else tqp.QUANT_VEC_BYTES)
    packed, new_base = vec_model(tx, tb, tu, tv, vec)
    jpacked, jnew = jqp.binary_quant_fastpath(*map(jnp.asarray, (x, base, u, v)), interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    jnew = np.asarray(jnew, np.float64)
    assert np.max(np.abs(new_base.numpy() - jnew) / np.maximum(np.abs(jnew), 1e-30)) <= REL
    twin_packed, twin_base = tqp.binary_quant_fastpath_ref(tx, tb, tu, tv)
    assert torch.equal(packed, twin_packed) and torch.equal(new_base, twin_base)
    # the dequant twin rebuilds the model's new base bit for bit: the EF
    # consistency invariant
    assert torch.equal(tqp.binary_dequant_fastpath_ref(packed, tb, tu, tv), new_base)


@pytest.mark.parametrize("vec", [1, tqp.QUANT_VEC_BYTES])
def test_vector_mapping_on_bf16_bases(vec):
    """bf16 x and base: the 8-byte accesses round the new base once, as the
    twin does."""
    x, base, u, v = _data(64, 256, 2, seed=7)
    tx, tb = torch.from_numpy(x).bfloat16(), torch.from_numpy(base).bfloat16()
    tu, tv = params_from_numpy(u), params_from_numpy(v)
    packed, new_base = vec_model(tx, tb, tu, tv, vec)
    twin_packed, twin_base = tqp.binary_quant_fastpath_ref(tx, tb, tu, tv)
    assert new_base.dtype == torch.bfloat16
    assert torch.equal(packed, twin_packed) and torch.equal(new_base, twin_base)
