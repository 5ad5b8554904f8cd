"""The wide-head route (``csrc/flash_wide.cuh``) of kernels 1, 4, 7 and 8
on the CPU.

The CUDA body runs only on the card, so its schedule is modelled here in
torch: per K/V tile of ``kWideBK`` keys (half as many in fp32), each
head-dim slice's partial scores, added in (CTA, slice) order (the exchange
between the warps of a row group, across the CTAs of a cluster above
d = 512), the online softmax in the exp2 domain with P rounded to bf16
before the PV product (kept in fp32 on fp32 inputs), each slice's
accumulator, the band's mask (kernel 4) and the state carried from hop to
hop (kernels 7 and 8).  The model is held against the JAX
``flash_attn_with_lse`` (the Pallas kernel in interpret mode, as
``tests/test_torch_flash.py`` runs it) at d=512 with ragged ``kv_lens``, at
the tolerances ``chip_smoke.py`` holds the kernel to against its twin (out
2e-2: P and the output round to bf16; LSE 1e-3), and against the port's
twins at the other wide head dims, banded and on a ring.  Faults of one
slice's warps, planted in the model, show what ``chip_smoke.py``'s relative
limit on out catches at the VAE's shape.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.ops import ring_flash_pallas as jrf
from compactfusion_tpu.ops.flash_pallas import flash_attn_with_lse as jflash
from compactfusion_tpu_torch.ops import flash as tflash
from compactfusion_tpu_torch.ops import ring_flash as trf

OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
LOG2E = 1.4426950408889634
REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "compactfusion_tpu_torch" / "csrc" / "flash_wide.cuh"
#: keys per K/V tile of the wide body
BK = int(re.search(r"constexpr int kWideBK = (\d+);", SRC.read_text()).group(1))


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


#: faults of the warps of head-dim slice 1 that the model can plant: its O
#: not rescaled when the running max grows, or the PV product of the last
#: key tile's second 16 keys left out
FAULTS = ("unscaled", "lost_keys")


def wide_model(q, k, v, kv_lens=None, fault=None, window=None, hops=None, elem=2):
    """The wide body's arithmetic at ``flash_plan``'s plan for ``elem``-byte
    elements (2: P rounded to bf16, 32-key tiles; 4: P in fp32, 16-key
    tiles), fp32 q/k/v (B, S, H, D) -> (out (B, S, H, D), lse (B, H, S));
    rows are independent, so every row group of the grid is computed at
    once, and a visited tile with no key of a row leaves its state as it
    was, so the band's tile schedule need not be modelled, only its mask.
    ``window``: kernel 4's band (Sq == Sk); ``hops``: kernel 7's (k, v) of
    every hop after the first, the state carried from hop to hop; ``fault``:
    one of :data:`FAULTS`, planted in slice 1."""
    b, sq, h, d = q.shape
    body, dp, _ = tflash.flash_plan(b, h, sq, d, elem=elem)
    assert body == "flash_wide_tile"
    parts, slices = tflash.wide_parts(dp), tflash.wide_slices(dp)
    ds = dp // parts // slices  # the slices of CTA p are p * slices .. p * slices + slices - 1
    bk = BK * 2 // elem
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))  # noqa: E731
    qp = pad(q)
    kvs = [(pad(k), pad(v))] + [(pad(kh), pad(vh)) for kh, vh in hops or ()]
    out = torch.zeros((b, sq, h, d))
    lse = torch.empty((b, h, sq))
    rows = torch.arange(sq)
    for bi in range(b):
        for hi in range(h):
            qq = qp[bi, :, hi]
            m = torch.full((sq,), float("-inf"))
            l = torch.zeros(sq)
            o = torch.zeros((sq, dp))
            for kp, vp in kvs:
                sk = kp.shape[1]
                kv_len = sk if kv_lens is None else min(max(int(kv_lens[bi]), 0), sk)
                for k0 in range(0, kv_len, bk):
                    kk, vv = kp[bi, k0:k0 + bk, hi], vp[bi, k0:k0 + bk, hi]
                    cols = torch.arange(k0, k0 + kk.shape[0])
                    part = [qq[:, j * ds:(j + 1) * ds] @ kk[:, j * ds:(j + 1) * ds].T for j in range(parts * slices)]
                    sc = part[0]
                    for p_s in part[1:]:  # the exchange: (CTA, slice) order
                        sc = sc + p_s
                    keep = cols[None, :] < kv_len
                    if window is not None:
                        keep = keep & ((rows[:, None] - cols[None, :]).abs() <= window)
                    sc = torch.where(keep, sc * (d**-0.5 * LOG2E), torch.tensor(float("-inf")))
                    m_new = torch.maximum(m, sc.amax(-1))
                    ref = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                    p = torch.exp2(sc - ref[:, None])
                    alpha = torch.exp2(m - ref)
                    l = l * alpha + p.sum(-1)
                    pb = p.to(torch.bfloat16).float() if elem == 2 else p
                    for j in range(parts * slices):  # each slice's warp: its own columns of O
                        cs = slice(j * ds, (j + 1) * ds)
                        a, p_s = alpha, pb
                        if j == 1 and fault == "unscaled":
                            a = torch.ones_like(alpha)
                        if j == 1 and fault == "lost_keys" and k0 + bk >= kv_len:
                            p_s = torch.cat([pb[:, :16], torch.zeros_like(pb[:, 16:])], dim=1)
                        o[:, cs] = o[:, cs] * a[:, None] + p_s @ vv[:, cs]
                    m = m_new
            inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            out[bi, :, hi] = (o * inv[:, None])[:, :d]
            lse[bi, hi] = torch.where(l > 0, (m + torch.log2(l)) / LOG2E, torch.tensor(float("-inf")))
    return out, lse


def _close(t, ref, atol):
    t, ref = np.asarray(t), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(t), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(t[fin], ref[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("b,s,lens", [(1, 96, None), (2, 96, (96, 5)), (2, 256, (200, 37))])
def test_wide_model_matches_jax_flash_at_d512(b, s, lens):
    """The split-D schedule at the VAE's head dim against the Pallas
    kernel (interpret mode) with ragged ``kv_lens``."""
    q, k, v = _qkv(b, s, s, 1, 512, seed=s + b)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    pal_o, pal_l = jflash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=128, interpret=True,
                          kv_lens=jl)
    out, lse = wide_model(*map(torch.from_numpy, (q, k, v)), lens)
    _close(out.numpy(), pal_o, OUT_ATOL)
    _close(lse.numpy(), pal_l, LSE_ATOL)
    # the model is the twin up to P's bf16 rounding and the order of sums
    ref_o, ref_l = tflash.flash_attn_with_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                                  kv_lens=None if lens is None else torch.tensor(lens))
    _close(out.numpy(), ref_o.numpy(), OUT_ATOL)
    _close(lse.numpy(), ref_l.numpy(), LSE_ATOL)


@pytest.mark.parametrize("d,lens", [(136, (70, 3)), (264, (0, 50)), (384, None), (576, (70, 0)), (1032, None),
                                    (2048, (9, 70))])
def test_wide_model_matches_the_twin(d, lens):
    """The other slice widths (2 x 80, 3 x 96, 3 x 128) and clusters of 2, 3
    and 4 CTAs (2 x 3 x 96, 3 x 3 x 128, 4 x 4 x 128), a row with no key
    included (0 and LSE -inf, the twin's convention)."""
    q, k, v = map(torch.from_numpy, _qkv(2, 40, 70, 2, d, seed=d))
    tl = None if lens is None else torch.tensor(lens)
    out, lse = wide_model(q, k, v, tl)
    ref_o, ref_l = tflash.flash_attn_with_lse_ref(q, k, v, kv_lens=tl)
    _close(out.numpy(), ref_o.numpy(), OUT_ATOL)
    _close(lse.numpy(), ref_l.numpy(), LSE_ATOL)
    if lens is not None and 0 in lens:
        assert (out[lens.index(0)] == 0).all()


def _bf16(*arrays):
    """fp32 arrays with bf16 values (the kernels' inputs on the bf16 route)."""
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays)


def test_kernel_1_twin_and_model_match_pallas_interpret_at_d576():
    """Kernel 1 at d = 576 (a cluster of 2 CTAs of 3 x 96 columns): the twin
    that the launches are held to on the card and the model of the split
    schedule, on bf16 values, against the Pallas kernel in interpret mode."""
    q, k, v = _bf16(*_qkv(1, 48, 80, 2, 576, seed=576))
    pal_o, pal_l = jflash(*map(jnp.asarray, (q, k, v)), block_q=16, block_k=128, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert tflash.flash_plan(1, 2, 48, 576) == ("flash_wide_tile", 576, 6)
    for out, lse in (tflash.flash_attn_with_lse(tq, tk, tv), wide_model(tq, tk, tv)):
        _close(out.numpy(), pal_o, OUT_ATOL)
        _close(lse.numpy(), pal_l, LSE_ATOL)


@pytest.mark.parametrize("d,w", [(256, 9), (256, 0), (576, 20)])
def test_kernel_4_twin_and_model_match_pallas_interpret(d, w):
    """Kernel 4 on the wide body (d = 256 on one CTA, d = 576 on a cluster
    of 2): the banded twin and the model against the Pallas window kernel
    in interpret mode, w = 0 (the diagonal alone) included."""
    q, k, v = _bf16(*_qkv(1, 70, 70, 2, d, seed=d + w))
    pal_o, pal_l = jflash(*map(jnp.asarray, (q, k, v)), block_q=16, block_k=128, interpret=True, window=w)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for out, lse in (tflash.flash_attn_window_with_lse(tq, tk, tv, w), wide_model(tq, tk, tv, window=w)):
        _close(out.numpy(), pal_o, OUT_ATOL)
        _close(lse.numpy(), pal_l, LSE_ATOL)


def _jax_ring(ring, q, k, v):
    """The Pallas ring kernel (interpret mode) on a ring of ``ring`` CPU
    devices, q/k/v (B, S, H, D) sequence-sharded over it: out, lse."""
    mesh = JMesh(np.array(jax.devices()[:ring]), ("ring",))
    spec = P(None, "ring", None, None)

    def body(q, k, v):
        return jrf.ring_flash_attn_with_lse(q, k, v, axis_name="ring", ring_size=ring,
                                            mesh_axes=(("ring", ring),), block_q=16, block_k=128,
                                            interpret=pltpu.InterpretParams(dma_execution_mode="eager"))

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                               out_specs=(spec, P(None, None, "ring")), check_vma=False))
    out, lse = fn(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), np.asarray(lse)


def test_kernel_7_twin_and_model_match_pallas_interpret_at_d256():
    """Kernel 7 at d = 256 on a ring of 2: rank 0's hops (its own K/V, then
    rank 1's) through the twin and through the model with the state
    carried from hop to hop, against the Pallas ring kernel in interpret
    mode on a 2-device CPU mesh."""
    ring, s_local = 2, 40
    q, k, v = _bf16(*_qkv(1, ring * s_local, ring * s_local, 2, 256, seed=7))
    pal_o, pal_l = _jax_ring(ring, q, k, v)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v))
    q0 = tq[:, :s_local].contiguous()
    blocks = [(tk[:, r * s_local:(r + 1) * s_local].contiguous(), tv[:, r * s_local:(r + 1) * s_local].contiguous())
              for r in range(ring)]
    twin = trf.ring_flash_attn_with_lse(q0, iter(blocks), ring)
    model = wide_model(q0, *blocks[0], hops=blocks[1:])
    for out, lse in (twin, model):
        _close(out.numpy(), pal_o[:, :s_local], OUT_ATOL)
        _close(lse.numpy(), pal_l[:, :, :s_local], LSE_ATOL)


def test_slice_order_of_the_exchange_is_fixed():
    """Adding the slices' partial scores in another order gives other fp32
    bits: the warps of a row group must all take the one order to hold the
    same scores (and so the same P) bit for bit."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(16, BK, generator=gen) * 10 for _ in range(4)]
    fwd = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    rev = ((parts[3] + parts[2]) + parts[1]) + parts[0]
    assert not torch.equal(fwd, rev) and torch.allclose(fwd, rev, atol=1e-4)


def _smoke_limits():
    """``chip_smoke.py``'s (FLASH_OUT_ATOL, FLASH_OUT_REL_MAX), read by path
    (the script imports nothing at its top but the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_limits", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_OUT_ATOL, mod.FLASH_OUT_REL_MAX


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_the_relative_limit_catches_a_fault_of_one_slice(fault):
    """At the VAE's B1 H1 S4096 d512 (outputs of RMS ~0.026) the model with
    its output rounded to bf16, as the kernel stores it, is within
    ``chip_smoke.py``'s relative limit of the twin, and each planted fault
    of one slice is over twice that limit; ``lost_keys`` (16 of 4096 keys
    lost in a quarter of the columns) exceeds the max-abs tolerance by a
    smaller factor than the relative limit."""
    atol, rel_max = _smoke_limits()
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16).float() for t in _qkv(1, 4096, 4096, 1, 512, seed=0))
    ref, _ = tflash.flash_attn_with_lse_ref(q, k, v)
    out = wide_model(q, k, v, fault=fault)[0].to(torch.bfloat16).float()
    rel = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
    max_abs = (out - ref).abs().max().item()
    if fault is None:
        assert rel <= rel_max / 2 and max_abs <= atol
    else:
        assert rel > 2 * rel_max
    if fault == "lost_keys":
        assert max_abs / atol < rel / rel_max
