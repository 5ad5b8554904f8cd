"""The flash stage probe (9b) and the plumb kernel's twin (9a) vs the JAX
probes of ``_prof_kernel_parts.py`` and ``_prof2_dbg.py``.

The two root scripts run their whole variant loop at full width when they
are imported, so they are never imported: :func:`load_functions` takes the
functions it needs out of the file with ``ast`` and executes only those,
in a namespace of small constants.  Their Pallas kernels run in interpret
mode on the CPU.

Tolerances: ``dma_only`` and plumb bit for bit (the same bf16 adds in the
same order).  Every other variant within 2e-2 absolute, one bf16 ulp at
the largest outputs (2-4, for ``no_scale`` and ``matmuls_only``), and
within 1e-2 relative Frobenius error, which holds at every output size:
the Pallas kernel rounds p to bf16 for its row sum where the twin sums
fp32 p, and exp against exp2 and the product order differ in the last
bits, which comes to 1e-3 - 2.6e-3 here (the largest, ``matmuls_only``).
``matmuls_only`` divides by l = the sum of raw scores, which can be near 0:
it is compared on the rows with |l| >= 8 * sqrt(S) (about 4 in 10 here),
where l's rounding moves the output by less than the tolerance.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from compactfusion_tpu_torch.ops import flash as tflash
from compactfusion_tpu_torch.ops import probes
from compactfusion_tpu_torch.probes import flash_parts as fp
from compactfusion_tpu_torch.probes import timing
from compactfusion_tpu_torch.utils.prof import Profiler, count

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-2
REL_MAX = 1e-2  # relative Frobenius error
L_FLOOR = 8.0  # times sqrt(S)
B, H, D = 1, 2, 72
STAGED = {n: p for n, p in fp.VARIANTS.items() if p is not None}


def load_functions(script, names, **namespace):
    """Execute only the top-level functions ``names`` of a root script in
    ``namespace`` (never the script's own top-level code) and return it."""
    path = REPO / script
    tree = ast.parse(path.read_text(), str(path))
    found = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in found) == sorted(names)
    exec(compile(ast.Module(found, []), str(path), "exec"), namespace)
    return namespace


def doctored_kernel(parts, s):
    """The Pallas call that ``_prof_kernel_parts.build(parts)`` makes, at
    B1 H2 S d72, in interpret mode."""
    made = []

    def pallas_call(*args, **kw):
        made.append(pl.pallas_call(*args, interpret=True, **kw))
        return made[-1]

    ns = load_functions("_prof_kernel_parts.py", ["kernel", "build"], jax=jax, jnp=jnp,
                        functools=functools, pltpu=pltpu, B=B, H=H, S=s, D=D, SCALE=D**-0.5,
                        pl=types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec))
    ns["build"](parts)
    return made[0]


def bf16_inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(ml_dtypes.bfloat16) for _ in range(n)]


def to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)


def run_both(parts, s, seed):
    """(JAX out (B, H, S, D) fp32, twin out the same, twin l (B, H, S)) on
    the same bf16 (B, H, S, D) inputs; the twin takes their (B, S, H, D)
    views, as the kernel does."""
    q, k, v = bf16_inputs((B, H, s, D), seed)
    jout = np.asarray(doctored_kernel(parts, s)(*map(jnp.asarray, (q, k, v)))).astype(np.float32)
    tq, tk, tv = (to_torch(a).transpose(1, 2) for a in (q, k, v))
    out, l = probes.flash_parts_ref(tq, tk, tv, parts, return_l=True)
    assert out.dtype == torch.bfloat16 and out.shape == (B, s, H, D) and out.is_contiguous()
    return jout, out.float().transpose(1, 2).numpy(), l


@pytest.mark.parametrize("s", [128, 256])  # two and four 64-key tiles
@pytest.mark.parametrize("name", [n for n in STAGED if n != "no_exp"])
def test_twin_matches_the_doctored_pallas_kernel(name, s):
    jout, tout, l = run_both(STAGED[name], s, seed=s)
    if name == "dma_only":
        np.testing.assert_array_equal(tout, jout)
        return
    rows = slice(None)
    if name == "matmuls_only":
        rows = np.abs(l.numpy()) >= L_FLOOR * np.sqrt(s)
        assert 0.2 < rows.mean() < 0.8
    np.testing.assert_allclose(tout[rows], jout[rows], atol=ATOL, rtol=0)
    assert np.linalg.norm(tout[rows] - jout[rows]) <= REL_MAX * np.linalg.norm(jout[rows])


@pytest.mark.parametrize("s", [128, 256])
def test_no_exp_twin_is_its_online_definition(s):
    """``exp`` off: p = s * scale - (the running max at the end of each
    64-key tile), alpha 1, written here as the kernel's loop over tiles."""
    q, k, v = (to_torch(a).float() for a in bf16_inputs((B, s, H, D), seed=s + 1))
    scale = D**-0.5
    m = torch.full((B, H, s, 1), -float("inf"))
    acc, l = torch.zeros(B, H, s, D), torch.zeros(B, H, s)
    for k0 in range(0, s, probes.TILE):
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k[:, k0:k0 + probes.TILE]) * scale
        m = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = sc - m
        acc += torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), v[:, k0:k0 + probes.TILE])
        l += p.sum(dim=-1)
    want = (acc / l[..., None]).transpose(1, 2)
    got = probes.flash_parts_ref(*(t.bfloat16() for t in (q, k, v)), STAGED["no_exp"])
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert np.linalg.norm(got.float().numpy() - want.numpy()) <= REL_MAX * np.linalg.norm(want.numpy())


def test_no_exp_diverges_from_pallas_only_where_the_max_moves():
    """The recorded divergence: the Pallas kernel subtracts the row's final
    max, the online body the running one.  With one key tile the two are
    the same; with four, the rows whose max is already in tile 0 agree and
    the others do not."""
    jout, tout, _ = run_both(STAGED["no_exp"], 64, seed=7)
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)

    s = 256
    jout, tout, _ = run_both(STAGED["no_exp"], s, seed=8)
    q, k, _ = (to_torch(a).float() for a in bf16_inputs((B, H, s, D), seed=8))
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k)
    settled = (sc[..., :probes.TILE].amax(-1) == sc.amax(-1)).numpy()  # (B, H, S)
    assert 0 < settled.mean() < 1
    err = np.abs(tout - jout).max(axis=-1)
    assert err[settled].max() <= ATOL
    assert err[~settled].max() > 2 * ATOL


@pytest.mark.parametrize("b,s,h,d", [(1, 64, 2, 24), (2, 128, 4, 72)])
def test_plumb_is_bit_equal_to_the_pallas_plumb(monkeypatch, b, s, h, d):
    """On column slices of one qkv tensor, as the block hands them over."""
    (qkv,) = bf16_inputs((b, s, 3 * h * d), seed=s + d, n=1)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    ns = load_functions("_prof2_dbg.py", ["_plumb"], jax=jax, jnp=jnp)
    jq, jk, jv = (x.reshape(b, s, h, d) for x in jnp.split(jnp.asarray(qkv), 3, axis=-1))
    want = np.asarray(ns["_plumb"](jq, jk, jv)).astype(np.float32)
    tq, tk, tv = (x.view(b, s, h, d) for x in to_torch(qkv).split(h * d, dim=-1))
    tflash._check_qkv(tq, tk, tv)  # the kernel's contract holds for these views
    got = probes.plumb(tq, tk, tv)
    assert got.shape == (b, s, h, d) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrappers_on_cpu_run_their_twins_without_counting():
    q, k, v = (to_torch(a).transpose(1, 2) for a in bf16_inputs((1, 2, 128, 72), seed=3))
    Profiler.reset()
    for parts in STAGED.values():
        assert torch.equal(probes.flash_parts(q, k, v, parts), probes.flash_parts_ref(q, k, v, parts))
    assert torch.equal(probes.plumb(q, k, v), probes.plumb_ref(q, k, v))
    assert Profiler.counter("flash_parts.launches") == 0 and Profiler.counter("plumb.launches") == 0
    # every stage on is kernel 1: its twin agrees with kernel 1's
    full = probes.flash_parts_ref(q, k, v, probes.STAGES).float()
    ref, _ = tflash.flash_attn_with_lse_ref(q, k, v)
    assert (full - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("parts,shape,match", [
    (("qk", "softmax"), (1, 128, 2, 72), "unknown flash stages"),
    (("qk",), (1, 128, 2, 72), "not one of the probe's variants"),
    (probes.STAGES, (1, 96, 2, 72), "multiple of 64"),
    (("qk", "scale", "max", "exp"), (1, 64, 2, 72), "without av"),
])
def test_flash_parts_rejects_what_the_kernel_does_not_build(parts, shape, match):
    q = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        probes.flash_parts(q, q, q, parts)


def test_entry_point_runs_every_variant_on_the_cpu_when_asked():
    rows = fp.run(device="cpu", b=1, h=2, s=128)
    assert [r["name"] for r in rows] == list(fp.VARIANTS)
    q, k, v = fp.make_inputs(torch.Generator().manual_seed(0), 1, 2, 128, 72)
    assert q.shape == (1, 128, 2, 72) and q.transpose(1, 2).is_contiguous()
    want = {n: probes.flash_parts_ref(q, k, v, p) for n, p in STAGED.items()}
    want["real"] = tflash.flash_attn_with_lse_ref(q, k, v)[0]
    want["sdpa"] = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    for r in rows:
        assert r["us_per_call"] is None and r["delta_vs_full_us"] is None and r["launches"] is None
        assert torch.equal(r["out"], want[r["name"]]), r["name"]
        assert "not measured" in fp.format_row(r)


def test_entry_points_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fp.run(["full"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        fp.main(["full"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.per_call_ms(lambda: None, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.copies(1 << 20)


def test_rotated_calls_take_turns_and_keep_their_outputs():
    """Each call of a rotation runs the next input set's call, and its output
    stays alive until that set's turn comes again (so a CUDA graph captures
    each output at its own address)."""
    import weakref

    fn = timing.rotate([lambda i=i: torch.full((1,), float(i)) for i in range(3)])
    values, refs = [], []
    for _ in range(7):
        out = fn()
        values.append(int(out))
        refs.append(weakref.ref(out))
    del out
    assert values == [0, 1, 2, 0, 1, 2, 0]
    assert [r() is not None for r in refs] == [False] * 4 + [True] * 3


def test_bounds_count_the_products_each_variant_keeps():
    b, h, s, d = fp.B, fp.H, fp.S, fp.D
    io = 4 * b * s * h * d * 2
    full_ms, by = fp.bound("full")
    assert by == "operations" and full_ms == pytest.approx(4 * b * h * s * s * d / 989e12 * 1e3)
    io_ms = io / 3.35e12 * 1e3
    assert fp.bound("matmuls_only")[0] == pytest.approx(full_ms)
    assert fp.bound("dma_only") == (pytest.approx(io_ms), "bytes")
    # one product is below the bytes of q, k, v and out at this shape
    assert full_ms / 2 < io_ms and fp.bound("no_av") == (pytest.approx(io_ms), "bytes")


def test_replayed_launches_count_once_per_replay():
    def kernel():
        pass

    Profiler.reset()
    count("kernel.launches", 5)
    before = timing.counts([kernel])
    count("kernel.launches", 1 + 20 + 120)  # a warm-up call, then two captures
    ran = timing._ran([kernel], before, [({"kernel": 20}, 3), ({"kernel": 120}, 3)])
    assert ran == {"kernel": 1 + 3 * 20 + 3 * 120}


def test_build_log_names_each_kernel_once(monkeypatch):
    """``ptxas -v`` lines are read per kernel, under labels that keep the
    template arguments and drop nvcc's per-file namespace names.  The CUDA
    toolkit's ``cu++filt`` is GNU ``c++filt``'s demangler with its flags;
    the CPU has only the latter."""
    import shutil

    from compactfusion_tpu_torch.ops import _build

    cxxfilt = shutil.which("c++filt")
    assert cxxfilt, "binutils' c++filt stands in for the CUDA toolkit's cu++filt"
    monkeypatch.setattr(_build, "_cufilt", lambda: cxxfilt)
    ns = "_ZN46_GLOBAL__N__0110b69f_13_flash_attn_cu_3b6b32e1"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}16flash_fwd_kernelILi4ELi64EEEvPK13__nv_bfloat16' for 'sm_90a'",
        f"ptxas info    : Function properties for {ns}16flash_fwd_kernelILi4ELi64EEEvPK13__nv_bfloat16",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__bead17f2_9_probes_cu_617b64f812plumb_kernelEPK13"
        "__nv_bfloat16' for 'sm_90a'",
        "ptxas info    : Used 31 registers, used 0 barriers",
    ])
    assert _build.ptxas_summary(log) == {
        "flash_fwd_kernel<4, 64>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
                                   "Used 64 registers, used 1 barriers",
        "plumb_kernel": "Used 31 registers, used 0 barriers"}
    quant = "_ZN46_GLOBAL__N__17503770_13_int2_quant_cu_be593f6d17int2_quant_kernelI13__nv_bfloat16S1_EEvPKT_"
    parts = f"{ns}18flash_parts_kernelILi31EEEv"
    assert _build.kernel_labels([quant, parts, "_Z3barv"]) == {
        quant: "int2_quant_kernel<__nv_bfloat16, __nv_bfloat16>", parts: "flash_parts_kernel<31>",
        "_Z3barv": "bar"}
    # what cu++filt says of the same name
    assert _build._UNLABELLED.sub("", "<unnamed>::flash_fwd_kernel<(int)4, (int)64>") == "flash_fwd_kernel<4, 64>"
