"""The block probe (9a, ``probes/block_parts.py``) vs the JAX probe
``_prof2_dbg.py``: its parameter tree and every ported variant of its
forward, on the same parameters and inputs.

The JAX functions (``make_params``, ``_heads``, ``_unheads``, ``_plumb``,
``make_fwd``) are taken out of the script with ``ast`` (it runs its variant
loop at full width when imported), at depth 2, dim 96, 4 heads, S 64 and 8
text tokens; ``_plumb``'s Pallas call runs in interpret mode.  JAX
``make_params`` carries over through ``io/from_jax.params_from_numpy``.

Tolerances: fp32 on both sides within the 2e-4 relative bound of
tests/io/test_backbone_parity.py (the frameworks differ in fp32 summation
order, and the no-LSE routes of both ``sdpa``s shift the exponent by
different amounts: JAX by a Cauchy-Schwarz bound, the port by the row
max).  The bf16 forward, the probe's
own dtype, within 2e-2: XLA may keep a fused chain of bf16 elementwise ops
in fp32 where torch rounds after each op, and two blocks compound it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.ops.attention import attn_with_lse as j_attn_with_lse
from compactfusion_tpu.ops.attention import sdpa as j_sdpa
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.probes import block_parts as bp
from tests.helpers import rel_err
from tests.test_torch_probes import load_functions

DEPTH, DIM, HEADS, B, S, ST = 2, 96, 4, 2, 64, 8
LENS = (8, 5)  # the second row's text is padded
BOUND = 2e-4
BF16_BOUND = 2e-2
#: port variant -> the JAX variant of ``_prof2_dbg.py`` that computes the same
#: function (the splash yardstick is TPU-only; SDPA computes ``full``)
JAX_NAME = {"cross_lse": "cross_xla", "self_sdpa": "full"}
JAX_KW = {"full": {}, "no_self_attn": {"self_attn": False}, "no_cross": {"cross": False},
          "no_ffn": {"ffn": False}, "no_modulation": {"modulate": False},
          "cross_xla": {"cross_impl": "xla"}, "self_transpose": {"self_kw": "transpose_probe"},
          "self_plumb": {"self_kw": "plumb_probe"}}


@pytest.fixture(scope="module")
def jax_probe():
    return load_functions("_prof2_dbg.py", ["make_params", "_heads", "_unheads", "_plumb", "make_fwd"],
                          jax=jax, jnp=jnp, cm=jcm, sdpa=j_sdpa, attn_with_lse=j_attn_with_lse,
                          flash_attn_with_lse=None, L=DEPTH, d=DIM, h=HEADS)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x, text, mod6 = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((B, S, DIM), (B, ST, DIM), (B, 6, DIM)))
    return x, text, mod6, np.asarray(LENS, np.int32)


def _forwards(jax_probe, inputs, name, dtype):
    """(port out, JAX out) of variant ``name`` on the JAX parameters (and
    inputs) cast to ``dtype`` on both sides."""
    jparams = jax.tree_util.tree_map(np.asarray, jax_probe["make_params"](jax.random.PRNGKey(0)))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x, text, mod6, lens = inputs
    jfwd = jax_probe["make_fwd"](**JAX_KW[JAX_NAME.get(name, name)])
    want = jfwd(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), jparams),
                *(jnp.asarray(a, jdt) for a in (x, text, mod6)), jnp.asarray(lens))
    tparams = params_from_numpy(jparams, dtype=dtype)
    got = bp.make_fwd(**bp.VARIANTS[name], heads=HEADS)(
        tparams, *(torch.from_numpy(a).to(dtype) for a in (x, text, mod6)), torch.from_numpy(lens))
    assert got.dtype == dtype and got.shape == (B, S, DIM)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("name", list(bp.VARIANTS))
def test_variant_matches_the_jax_block_probe(jax_probe, inputs, monkeypatch, name):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    got, want = _forwards(jax_probe, inputs, name, torch.float32)
    assert rel_err(got, want) < BOUND


def test_bf16_forward_matches_the_jax_block_probe(jax_probe, inputs):
    got, want = _forwards(jax_probe, inputs, "full", torch.bfloat16)
    assert np.isfinite(got).all()
    assert rel_err(got, want) < BF16_BOUND


def test_variants_change_the_forward(jax_probe, inputs, monkeypatch):
    """Each part left out changes the result (the comparison above is not
    between two identical forwards); the replacements of self-attention
    that move no attention math (transpose, plumb) differ from it."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    outs = {n: _forwards(jax_probe, inputs, n, torch.float32)[0] for n in bp.VARIANTS}
    for name in ("no_self_attn", "no_cross", "no_ffn", "no_modulation", "self_plumb"):
        assert rel_err(outs[name], outs["full"]) > 1e-3, name
    assert rel_err(outs["cross_lse"], outs["full"]) < BOUND
    np.testing.assert_array_equal(outs["self_transpose"], outs["no_self_attn"])


def test_make_params_mirrors_the_jax_tree(jax_probe):
    jparams = jax_probe["make_params"](jax.random.PRNGKey(0))
    tparams = bp.make_params(torch.Generator().manual_seed(0), DEPTH, DIM)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                tflat[path + (key,)] = val

    walk(tparams, ())
    assert len(tflat) == len(jleaves)
    for path, leaf in jleaves:
        t = tflat[tuple(p.key for p in path)]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape, path
        jstd, tstd = float(jnp.std(leaf.astype(jnp.float32))), t.float().std().item()
        assert tstd == pytest.approx(jstd, rel=0.1, abs=1e-12), path


def test_entry_point_runs_every_variant_on_the_cpu_when_asked():
    rows = bp.run(device="cpu", depth=DEPTH, dim=DIM, heads=HEADS, b=B, s=S, st=ST)
    assert [r["name"] for r in rows] == list(bp.VARIANTS)
    gen = torch.Generator().manual_seed(0)
    params = bp.make_params(gen, DEPTH, DIM)
    x, text, mod6, lens = bp.make_inputs(gen, B, S, ST, DIM)
    assert x.dtype == torch.bfloat16 and lens.tolist() == [ST] * B
    for r in rows:
        want = bp.make_fwd(**bp.VARIANTS[r["name"]], heads=HEADS)(params, x, text, mod6, lens)
        assert torch.equal(r["out"], want), r["name"]
        assert r["replay_ms"] is None and r["launches"] is None and "not measured" in bp.format_row(r)
    assert bp.breakdown(rows) == []


def test_breakdown_reads_the_replay_deltas():
    rows = [{"name": n, "replay_ms": t} for n, t in
            (("full", 30.0), ("no_self_attn", 20.0), ("no_cross", 27.0), ("self_plumb", 21.0))]
    got = {part: (cost, share) for part, cost, share in bp.breakdown(rows)}
    assert got == {"self-attention (kernel 1)": (10.0, pytest.approx(1 / 3)),
                   "cross-attention": (3.0, pytest.approx(0.1)),
                   "plumb in place of attention": (1.0, pytest.approx(1 / 30))}


@pytest.mark.parametrize("kw", [{"cross_impl": "xla"}, {"self_kw": "splash_probe"}])
def test_make_fwd_refuses_the_unported_modes(kw):
    x = torch.zeros(1, 64, DIM)
    params = bp.make_params(torch.Generator().manual_seed(0), 1, DIM)
    with pytest.raises(ValueError):
        bp.make_fwd(**kw, heads=HEADS)(params, x, x[:, :8], x[:, :6], torch.tensor([8]))


def test_entry_point_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bp.run(["full"], depth=1, dim=DIM, heads=HEADS)
