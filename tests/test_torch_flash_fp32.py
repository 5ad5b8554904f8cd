"""The fp32 branch of kernels 1, 4, 7 and 8 (the Pallas kernels take the
input dtype), on the CPU: routing, the wrappers' checks, the fp32 plans and
the shared-memory layouts they mirror from ``csrc/``, and the compressed
ring's twin in fp32 against the Pallas ``compact_binary_ring_flash`` in
interpret mode.

The kernels themselves run only on the card (``chip_smoke.py`` phase 20
holds each fp32 kernel against its twin there); here every wrapper runs its
twin on CPU tensors.
"""

import ctypes
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
from compactfusion_tpu_torch.ops import attention as tattn
from compactfusion_tpu_torch.ops import flash as tflash
from compactfusion_tpu_torch.ops import ring_flash as trf
from compactfusion_tpu_torch.utils.prof import Profiler
from tests.helpers import rel_err
from tests.test_torch_flash_plan import c_struct

REPO = Path(__file__).resolve().parent.parent
# the compressed ring's twin vs the Pallas kernel in fp32: out as the flash
# twins are held (tests/test_torch_flash.py, fp32 summation order); EF
# stacks to tests/test_torch_compact_ring.py's BASE_REL
OUT_ATOL, BASE_REL = 2e-4, 1e-6


def _qkv(b, sq, sk, h, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


# -- the route and the wrappers' checks ------------------------------------------


def test_fp32_routes_to_the_kernel_wrapper(monkeypatch):
    """A call the contract sends to the kernel goes to the flash wrapper in
    fp32 as in bf16 (routing forced, as on a CUDA tensor); on the CPU the
    wrapper runs its twin, bit for bit."""
    monkeypatch.setattr(tattn, "_flash_eligible", lambda *a: True)
    seen = []

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return tflash.flash_attn_with_lse(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attn_with_lse", spy)
    q, k, v = _qkv(1, 32, 64, 2, 72, seed=3)
    out, lse = tattn.attn_with_lse(q, k, v)
    ref_o, ref_l = tflash.flash_attn_with_lse_ref(q, k, v)
    assert seen == [torch.float32] and out.dtype == torch.float32
    assert torch.equal(out, ref_o) and torch.equal(lse, ref_l)
    # sdpa takes the same route and drops the LSE
    assert torch.equal(tattn.sdpa(q, k, v), ref_o) and seen == [torch.float32] * 2


def test_fp16_raises_type_error():
    """fp16 is not ported: the kernels' checks and plans refuse it, naming
    ROADMAP."""
    q, k, v = _qkv(1, 32, 64, 2, 72, seed=4, dtype=torch.float16)
    with pytest.raises(TypeError, match="ROADMAP"):
        tflash._check_qkv(q, k, v)
    with pytest.raises(TypeError, match="ROADMAP"):
        tflash.launch_plan(1, 2, 32, 72, torch.float16)
    # q and k/v of two dtypes are refused too
    q32, k32, _ = _qkv(1, 32, 64, 2, 72, seed=4)
    with pytest.raises(TypeError, match="v is torch.bfloat16"):
        tflash._check_qkv(q32, k32, k32.to(torch.bfloat16))


def test_fp32_view_not_16_byte_aligned_raises():
    """fp32 views need (b, s, h) strides that are multiples of 4 elements
    and a 16-byte aligned start: one float in raises, four floats in pass."""
    n = 2 * 64 * 2 * 72
    buf = torch.zeros(n + 8)
    assert buf.data_ptr() % 16 == 0
    ok = buf[4:4 + n].view(2, 64, 2, 72)
    tflash._check_qkv(ok, ok, ok)
    off = buf[1:1 + n].view(2, 64, 2, 72)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash._check_qkv(off, ok, ok)
    odd = torch.zeros(2 * 64 * 2 * 74).as_strided((2, 64, 2, 72), (64 * 2 * 74, 2 * 74, 74, 1))
    with pytest.raises(ValueError, match="multiples of 4"):
        tflash._check_qkv(ok, odd, odd)
    # bf16 keeps its rule: strides that are multiples of 8 elements
    bf = torch.zeros(2 * 64 * 2 * 76, dtype=torch.bfloat16).as_strided((2, 64, 2, 72), (64 * 2 * 76, 2 * 76, 76, 1))
    with pytest.raises(ValueError, match="multiples of 8"):
        tflash._check_qkv(bf, bf, bf)


def test_fp32_flash_tile_raises_not_implemented():
    """An fp32 launch above the register body (kernel 1, 4, 7 or 8's flash
    partial above d = 128) takes the plan of the same call on bf16, the
    wide body, run on its fp32 instantiations; every wrapper plans through
    ``launch_plan``, and no fp32 plan raises up to the widest head dim."""
    for d in (136, 512, 520, 1024, 1552, 2048):
        got = tflash.launch_plan(1, 1, 4096, d, torch.float32)
        assert got == (tflash.launch_plan(1, 1, 4096, d, torch.bfloat16)[0], True)
        assert got[0][0] == "flash_wide_tile"
    assert tflash.launch_plan(1, 1, 4096, 512, torch.float32) == (("flash_wide_tile", 512, 8), True)
    src = (REPO / "compactfusion_tpu_torch" / "ops" / "flash.py").read_text()
    assert "NotImplementedError" not in src
    # kernel 1 and the ring hops name their kernel, whose bf16 launches up to
    # d = 128 take the wgmma body; fp32 takes the rule without it
    assert src.count("launch_plan(b, h, sq, d, q.dtype, kernel=1 if sk else None)") == 1
    assert src.count("launch_plan(b, h, s, d, q.dtype)") == 1
    ring = (REPO / "compactfusion_tpu_torch" / "ops" / "ring_flash.py").read_text()
    assert ring.count("launch_plan(b, h, sq, d, q.dtype, kernel=7)") == 2
    assert "flash_plan(" not in ring
    for d in (72, 128):
        assert tflash.launch_plan(1, 1, 4096, d, torch.float32, kernel=7)[0][0] == "flash_reg_tile"
    for cu in ("flash_attn.cu", "ring_flash.cu"):
        assert "flash_tile is bf16's" not in (REPO / "compactfusion_tpu_torch" / "csrc" / cu).read_text()


def _wide_plans():
    """Every (d, elem, split, one CTA's dp, warps) a wide plan takes: each
    multiple of 8 above 128 up to the widest head dim, in bf16 and fp32, on
    the kernels of one CTA (kernel 1 up to d = 512) and on the split ones
    (kernels 4, 7 and 8 at every width, kernel 1 above 512)."""
    out = []
    for d in range(136, tflash.WIDE_MAX_D + 1, 8):
        for elem in (2, 4):
            body, dp, warps = tflash.flash_plan(1, 1, 4096, d, elem=elem)
            assert body == "flash_wide_tile"
            parts = tflash.wide_parts(dp)
            for split in ((False, True) if parts == 1 else (True,)):
                out.append((d, elem, split, dp // parts, warps))
    return out


def test_fp32_flash_tile_plans_fit_the_card():
    """Every head dim that is a multiple of 8 gets a plan in bf16 and fp32
    up to ``WIDE_MAX_D`` (2048), built (``CF_WIDE_PLANS``,
    ``CF_WIDE_SPLIT_PLANS``), whose layout fits 227 KB: ``wide_layout``
    against ``WideLayout``'s statements, run here."""
    plans = _wide_plans()
    assert len({(d, elem) for d, elem, *_ in plans}) == 2 * len(range(136, 2049, 8))
    for d, elem, split, dp, warps in plans:
        built = tflash.WIDE_BUILT if split and d <= tflash.WIDE_PART or not split else tflash.WIDE_SPLIT_BUILT
        assert (dp, warps) in built, (d, elem, split)
        assert tflash.wide_layout(dp, warps, elem, split)["bytes"] <= tflash.SMEM_MAX, (d, elem, split)
    for dp, warps in tflash.WIDE_BUILT:
        for elem in (2, 4):
            for split in (False, True):
                c = _wide_layout_c(dp, warps, elem, split)
                assert c["kBytes"] == tflash.wide_layout(dp, warps, elem, split)["bytes"] <= tflash.SMEM_MAX


@pytest.mark.parametrize("d,window", [(576, None), (1024, None), (2048, None), (256, 24), (200, 0), (576, 9)])
def test_fp32_flash_tile_twin_and_schedule_match_pallas_interpret(d, window):
    """The twin that the fp32 wide-body launches are held to on the card
    (``chip_smoke.py`` phase 50), and a torch model of the body's fp32
    schedule (``tests/test_torch_wide_flash.py::wide_model``: 16-key tiles,
    the partials added in (CTA, slice) order, P in fp32), against the
    Pallas kernel in interpret mode at kernel 1's d = 576, 1024 and 2048
    (clusters of 2 and 4 CTAs) and kernel 4's banded d = 256, 200 and 576
    (w = 24, 0 and 9): out within 2e-6 relative, LSE within 1e-5."""
    from compactfusion_tpu.ops.flash_pallas import flash_attn_with_lse as jflash
    from tests.test_torch_wide_flash import wide_model

    s = 80
    q, k, v = _qkv(1, s, s, 2, d, seed=d + (window or 0))
    kw = {} if window is None else {"window": window}
    pal_o, pal_l = jflash(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), block_q=32, block_k=128,
                          interpret=True, **kw)
    pal_o, pal_l = np.asarray(pal_o), np.asarray(pal_l)
    twin = tflash.flash_attn_with_lse(q, k, v, window=window)  # a CPU tensor: the twin
    model = wide_model(q, k, v, window=window, elem=4)
    assert tflash.launch_plan(1, 2, s, d, torch.float32)[0][0] == "flash_wide_tile"
    for out, lse in (twin, model):
        assert out.dtype == torch.float32
        assert rel_err(out.numpy(), pal_o) < 2e-6
        np.testing.assert_allclose(lse.numpy(), pal_l, rtol=0, atol=1e-5)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}


def _c_entries():
    """{name: [ctypes type of each parameter]} of every ``extern "C"``
    entry in ``compactfusion_tpu_torch/csrc/*.cu``."""
    import re

    entries = {}
    for path in sorted((REPO / "compactfusion_tpu_torch" / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" [\w*]+\*? (cf_\w+)\(([^)]*)\)', path.read_text()):
            types_ = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
            entries[name] = [_C_TYPES[t] for t in types_]
    return entries


@pytest.mark.parametrize("name", ["cf_flash_attn", "cf_flash_attn_window", "cf_ring_flash_hop",
                                  "cf_ef_update_slot"])
def test_c_entry_takes_one_dtype_flag_and_matches_its_declaration(name):
    """Kernels 1, 4, 7 and the EF pass have one C entry each for both
    dtypes, choosing fp32 by an int before the stream; ``ops/_build.py``
    declares each entry's parameters as ``csrc/`` defines them, type for
    type, so a wrapper cannot hand the kernel a shifted argument."""
    from tests.test_torch_compact_ring import _declared_argtypes

    entries = _c_entries()
    assert not any(n.endswith(("_f32", "_bf16")) and n[:n.rindex("_")] in entries for n in entries)
    declared = list(_declared_argtypes(name))
    assert declared == entries[name]
    assert declared[-2:] == [ctypes.c_int, ctypes.c_void_p]
    src = "".join(p.read_text() for p in (REPO / "compactfusion_tpu_torch" / "ops").glob("*.py"))
    assert f"lib.{name}(" in src


# -- the fp32 plans and the layouts of csrc/ --------------------------------------


def _reg_layout_c(dp, warps, elem):
    return c_struct("flash_reg.cuh", "RegLayout", DP=dp, NWARPS=warps, ELEM=elem)


def _wide_layout_c(dp, warps, elem, split=False):
    return c_struct("flash_wide.cuh", "WideLayout", DP=dp, NWARPS=warps, ELEM=elem, SPLIT=split)


def _conflict_free(ld):
    """ldmatrix of Q and K: 8 rows of 16 bytes in 8 different bank groups
    (an odd number of 16-byte segments a row); the 32-bit V loads of a
    warp, rows 2t and 2t + 1 of 8 columns, in 32 different banks."""
    return (ld * 4 // 16) % 2 == 1 and len({(2 * t * ld + g) % 32 for t in range(4) for g in range(8)}) == 32


@pytest.mark.parametrize("dp,warps", sorted(tflash.REG_BUILT))
def test_fp32_register_plans_fit_the_card(dp, warps):
    """Every built register plan in fp32: rows of DP + 4 floats (bank-conflict
    free for ldmatrix and the V loads), the layout of ``RegLayout<DP, warps,
    4>`` (its statements run), within 227 KB, 2 stages where 3 do not fit;
    the plan rule picks the same (DP, warps) in fp32 as in bf16."""
    got = tflash.reg_layout(dp, warps, 4)
    c = _reg_layout_c(dp, warps, 4)
    assert (got["ld"], got["q_bytes"], got["tile_bytes"], got["stages"], got["bytes"]) == \
        (c["kLd"], c["kQBytes"], c["kTileBytes"], c["kStages"], c["kBytes"])
    assert got["ld"] == dp + 4 and _conflict_free(got["ld"])
    assert got["bytes"] <= tflash.SMEM_MAX
    three = got["q_bytes"] + 3 * 2 * got["tile_bytes"]
    assert got["stages"] == (3 if 2 * three <= tflash.SMEM_MAX else 2)
    if three > tflash.SMEM_MAX:
        assert got["stages"] == 2
    # bf16 keeps its layout: DP + 8 elements
    bf = tflash.reg_layout(dp, warps, 2)
    assert bf["ld"] == dp + 8 and bf["stages"] == _reg_layout_c(dp, warps, 2)["kStages"]
    for b, h, sq in ((2, 16, 1024), (1, 16, 512), (2, 16, 128), (1, 24, 4608)):
        assert tflash.flash_plan(b, h, sq, dp, elem=4) == tflash.flash_plan(b, h, sq, dp)


def test_fp32_at_dp_128_takes_two_stages():
    """FLUX's d=128 at 8 warps: a 67,584-byte Q tile and 33,792-byte K and V
    tiles; 3 stages (270,336 bytes) do not fit, 2 (202,752) do."""
    got = tflash.reg_layout(128, 8, 4)
    assert (got["q_bytes"], got["tile_bytes"], got["stages"], got["bytes"]) == (67584, 33792, 2, 202752)
    assert got["q_bytes"] + 6 * got["tile_bytes"] == 270336 > tflash.SMEM_MAX


@pytest.mark.parametrize("dp,warps", sorted(tflash.WIDE_BUILT))
def test_fp32_wide_plans_fit_the_card(dp, warps):
    """The wide body in fp32: tiles of 16 keys, rows of DP + 4 floats, the
    layout of ``WideLayout<DP, warps, 4>`` (and of the split kernels'
    ``WideLayout<DP, warps, 4, true>``); at the VAE's d=512 the Q tile, 2
    stages and the exchange come to 206,336 bytes, and 3 stages do not
    fit."""
    for split in (False, True):
        got = tflash.wide_layout(dp, warps, 4, split)
        c = _wide_layout_c(dp, warps, 4, split)
        assert (got["bk"], got["ld"], got["q_bytes"], got["tile_bytes"], got["xch_bytes"], got["stages"],
                got["bytes"]) == (c["kBK"], c["kLd"], c["kQBytes"], c["kTileBytes"], c["kXchBytes"], c["kStages"],
                                  c["kBytes"])
        assert got["bytes"] <= tflash.SMEM_MAX
    got = tflash.wide_layout(dp, warps, 4)
    assert got["bk"] == 16 and got["ld"] == dp + 4 and _conflict_free(got["ld"])
    assert got["bytes"] <= tflash.SMEM_MAX
    # bf16 keeps 32-key tiles and its layout
    assert tflash.wide_layout(dp, warps, 2)["bytes"] == _wide_layout_c(dp, warps, 2)["kBytes"]
    if dp == 512:
        assert tflash.flash_plan(1, 1, 4096, 512, elem=4) == ("flash_wide_tile", 512, 8)
        assert (got["stages"], got["bytes"]) == (2, 66048 + 2 * 2 * 33024 + 8192)
        assert got["q_bytes"] + 6 * got["tile_bytes"] + got["xch_bytes"] > tflash.SMEM_MAX


# -- kernel 8's twin in fp32 ---------------------------------------------------------


H, D, S_LOCAL = 2, 16, 16


def _ring_inputs(ring, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, S_LOCAL * ring, H, D)).astype(np.float32) for _ in range(3))
    n, c = S_LOCAL, H * D
    kb, vb = (rng.standard_normal((ring, n, c)).astype(np.float32) * 0.9 for _ in range(2))
    return q, k, v, kb, vb


def _jax_fused(ring, q, k, v, kb, vb):
    """The Pallas kernel (interpret mode) on a ring of ``ring`` CPU devices:
    out (B, S, H, D), lse and every device's new stacks."""
    mesh = JMesh(np.array(jax.devices()[:ring]), ("ring",))
    spec = P(None, "ring", None, None)

    def body(q, k, v, kb, vb):
        out, lse, nkb, nvb = jrf.compact_binary_ring_flash(
            q, k, v, kb[0], vb[0], axis_name="ring", ring_size=ring, mesh_axes=(("ring", ring),),
            codec="binary", interpret=pltpu.InterpretParams(dma_execution_mode="eager"))
        return out, nkb[None], nvb[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P("ring"), P("ring")),
                               out_specs=(spec, P("ring"), P("ring")), check_vma=False))
    stack = lambda s: jnp.broadcast_to(jnp.asarray(s)[None], (ring,) + s.shape)
    out, nkb, nvb = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), stack(kb), stack(vb))
    return np.asarray(out), np.asarray(nkb), np.asarray(nvb)


@pytest.mark.parametrize("ring", [2, 4])
def test_fp32_compact_ring_twin_matches_pallas_interpret(ring):
    """Every rank of the fused BINARY ring with fp32 activations: the twin's
    out within 2e-4 of the Pallas kernel's (which keeps fp32
    reconstructions as they are, ring_flash_pallas.py:646-650), its EF
    stacks within 1e-6 of the kernel's and bit-equal across ranks."""
    q, k, v, kb, vb = _ring_inputs(ring, seed=ring)
    ref_out, ref_kb, ref_vb = _jax_fused(ring, q, k, v, kb, vb)
    shards = [tuple(torch.from_numpy(np.ascontiguousarray(np.split(x, ring, axis=1)[r])) for x in (q, k, v))
              for r in range(ring)]
    kb0, vb0 = torch.from_numpy(kb), torch.from_numpy(vb)
    payloads = [trf.fused_ring_payload(shards[r][1], shards[r][2], kb0[r], vb0[r], "binary", -1)
                for r in range(ring)]
    stacks = []
    for r in range(ring):
        kr, vr = kb0.clone(), vb0.clone()
        out, lse = trf.compact_ring_flash_ref(*shards[r], kr, vr, iter([payloads[(r - s) % ring] for s in range(ring)]),
                                              codec="binary", my=r, ring_size=ring)
        assert out.dtype == torch.float32 and lse.shape == (1, H, S_LOCAL)
        np.testing.assert_allclose(out.numpy(), np.split(ref_out, ring, axis=1)[r], atol=OUT_ATOL, rtol=0)
        assert rel_err(kr.numpy(), ref_kb[r]) < BASE_REL and rel_err(vr.numpy(), ref_vb[r]) < BASE_REL
        stacks.append((kr, vr))
    for kr, vr in stacks[1:]:
        assert torch.equal(kr, stacks[0][0]) and torch.equal(vr, stacks[0][1])


def test_fp32_ef_pass_twin_writes_fp32_reconstructions():
    """The EF pass's wrapper on CPU stacks with fp32 activations: ``rec``
    (fp32) holds the reconstruction as it is, the slot's new base bit for
    bit, which bf16 could not hold; no launch is counted.  The pass takes
    the activation dtype from ``rec``, and an fp16 ``rec`` is refused."""
    q, k, v, kb, vb = _ring_inputs(2, seed=11)
    k0, v0 = (torch.from_numpy(np.ascontiguousarray(x[:, :S_LOCAL])) for x in (k, v))
    kw, vw = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
    payload = trf.fused_ring_payload(k0, v0, kw[1], vw[1], "binary", -1)
    shape = tuple(k0.shape)
    rec = tuple(torch.empty(shape, dtype=torch.float32) for _ in range(2))
    Profiler.reset()
    trf.ef_update_slot(kw, vw, 1, "binary", payload, shape, rec=rec)
    assert Profiler.counter("ef_update_slot.launches") == Profiler.counter("ef_update_slot.f32_launches") == 0
    for r, slot in zip(rec, (kw[1], vw[1])):
        assert torch.equal(r.reshape(slot.shape), slot)
        assert not torch.equal(r, r.to(torch.bfloat16).float())
    # the twin's reconstructions are the same fp32 values
    kt, vt = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
    for r, x in zip(rec, trf.ef_update_slot_ref(kt, vt, 1, "binary", payload)):
        assert x.dtype == torch.float32 and torch.equal(r, x.reshape(shape))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        trf.ef_update_slot(kw, vw, 1, "binary", payload, shape,
                           rec=tuple(torch.empty(shape, dtype=torch.float16) for _ in range(2)))


# -- the slice in fp32 ------------------------------------------------------------


def test_fp32_pipeline_takes_the_kernel_route_in_fp32(monkeypatch):
    """pixart_tiny + tiny_vae in fp32, 4 steps with CFG, with every call
    with no mask and no causal flag routed to the flash wrapper (as a CUDA
    tensor of a flash-eligible shape is): every call reaches it in fp32,
    nothing on the path rounds to bf16, and the latents stay within the
    fp32 bound (2e-4) of the JAX pipeline's on the same weights and noise."""
    import dataclasses

    from compactfusion_tpu.config import ParallelConfig as JParallel
    from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
    from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
    from compactfusion_tpu.parallel.mesh import make_mesh
    from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPipeline
    from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPipelineConfig
    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
    from tests.helpers import spice_params

    jm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_pixart(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 1, 6, jm.text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)
    jpipe = JPipeline(jparams, jvae, JPipelineConfig(model=jm, vae=jv, num_steps=4, height=64, width=64),
                      make_mesh(JParallel(), devices=jax.devices()[:1]))
    jlat = np.asarray(jpipe._sample(jparams, jnp.asarray(text), jnp.asarray(mask), jnp.asarray(latents0)))

    seen = []
    real = tflash.flash_attn_with_lse

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "_flash_eligible", lambda q, k, causal, mask: not causal and mask is None)
    monkeypatch.setattr(tattn, "flash_attn_with_lse", spy)
    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tpipe = PixArtPipeline(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)),
                           params_from_numpy(jax.tree_util.tree_map(np.asarray, jvae)),
                           PixArtPipelineConfig(model=tm, vae=tv, num_steps=4, height=64, width=64), "cpu")
    tlat = tpipe(torch.from_numpy(text), torch.from_numpy(mask), latents=torch.from_numpy(latents0), decode=False)
    img = tpipe.decode(tlat)
    # self- and cross-attention of every block and step, and the VAE's
    assert len(seen) == 2 * tm.depth * 4 + 1
    assert set(seen) == {(torch.float32,) * 3} and img.dtype == torch.float32
    assert rel_err(tlat.numpy(), jlat) < 2e-4
