"""Ulysses and hybrid USP (Ulysses x ring) across ranks vs the JAX package, in fp32.

One spawn of 4 gloo processes runs every case of the port on two meshes,
Ulysses 2 x ring 2 and Ulysses 4:

* the three all-to-all primitives (``parallel/ulysses.py``) on each rank's
  (ring, ulysses) shard, bit for bit against JAX's ``lax.all_to_all``
  (pure data movement), and the bytes each all-to-all sends;
* ``usp_attention`` with no joint tensors and with joint K/V (and a joint
  query) at the front and at the rear, unfused and through the fused ring
  kernel's twin, within 2e-4 of the JAX ``usp_attention`` (JAX runs its
  ppermute ring for the fused cases too: both compute the same values);
* ``compact_usp_attention`` BINARY (residual 1 + EF) at U2 x R2 over 3
  drifting steps, unfused and fused: outputs within 5e-5 and EF stacks
  within 1e-6 of the JAX run, and the stacks' deviation across the ring 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.compact.ring import compact_usp_attention as jcompact_usp
from compactfusion_tpu.compact.ring import init_ring_state as jinit
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.flux import flux_tiny as jflux_tiny
from compactfusion_tpu.models.pixart import pixart_tiny as jpixart_tiny
from compactfusion_tpu.models.vae import tiny_vae as jtiny_vae
from compactfusion_tpu.parallel import ulysses as july
from compactfusion_tpu.parallel.mesh import AXIS_RING, AXIS_ULYSSES, make_mesh
from compactfusion_tpu.parallel.usp import usp_attention as jusp
from compactfusion_tpu.pipelines import flux as jflux_pipe
from compactfusion_tpu.pipelines import pixart as jpipe
from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
from compactfusion_tpu_torch.models import flux as tflux
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.models.attn_impl import CompactUSPAttn
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.pipelines import flux as tflux_pipe
from compactfusion_tpu_torch.pipelines import pixart as tpipe
from tests.helpers import rel_err
from tests.test_torch_rank_fns import ulysses_outputs

B, S, H, D, SJ = 2, 32, 4, 16, 8
ATTN_REL, OUT_REL, BASE_REL = 2e-4, 5e-5, 1e-6
LAYOUTS = {"u2r2": (2, 2), "u4": (4, 1)}
SEQ = P(None, (AXIS_RING, AXIS_ULYSSES), None, None)
DEV = P((AXIS_RING, AXIS_ULYSSES))
# (layout, joint strategy, fused, with a joint query)
CASES = [(lay, j, f, False) for lay in LAYOUTS for j in ("none", "front", "rear") for f in (False, True)]
CASES += [(lay, j, f, True) for lay in LAYOUTS for j in ("front", "rear") for f in (False, True)]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _prim():
    return _arrays(0, (B, S, H, D), (B, SJ, H, D))


def _attn_inputs():
    return _arrays(1, *([(B, S, H, D)] * 3 + [(B, SJ, H, D)] * 3))


def _steps():
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((1, S, H, D)) for _ in range(3)]
    out = []
    for _ in range(3):
        x = [a + 0.05 * rng.standard_normal(a.shape) for a in x]
        out.append(tuple(a.astype(np.float32) for a in x))
    return out


@pytest.fixture(scope="module")
def spawned():
    return tmesh.spawn_local(ulysses_outputs, 4, "gloo", _prim(), CASES, _attn_inputs(), _steps(),
                             threads=1, timeout=300)


def _mesh(layout):
    u, r = LAYOUTS[layout]
    return make_mesh(JParallel(ulysses_degree=u, ring_degree=r), devices=jax.devices()[:4]), u, r


@functools.lru_cache(maxsize=None)
def _jax_prim(layout):
    mesh, u, _ = _mesh(layout)

    def body(x, j):
        a = july.scatter_heads_gather_seq(x, AXIS_ULYSSES)
        b = july.scatter_seq_gather_heads(a, AXIS_ULYSSES)
        return a[None], b[None], july.slice_joint_heads(j, AXIS_ULYSSES, u)[None]

    f = jax.shard_map(body, mesh=mesh, in_specs=(SEQ, P()), out_specs=(DEV, DEV, DEV), check_vma=False)
    return [np.asarray(t) for t in jax.jit(f)(*map(jnp.asarray, _prim()))]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_all_to_all_primitives_match_jax_bit_for_bit(spawned, layout):
    a_ref, b_ref, j_ref = _jax_prim(layout)
    u, r = LAYOUTS[layout]
    x = _prim()[0]
    for rank, res in enumerate(spawned):
        a, b, j, nbytes = res["prim"][layout]
        assert a.shape == (B, S // r, H // u, D)
        np.testing.assert_array_equal(a, a_ref[rank])
        np.testing.assert_array_equal(b, b_ref[rank])
        np.testing.assert_array_equal(j, j_ref[rank])
        # the inverse restores the rank's own shard
        n = S // (u * r)
        np.testing.assert_array_equal(b, x[:, rank * n:(rank + 1) * n])
        # the bytes sent to the other U - 1 ranks of the line
        assert nbytes == x[:, :n].nbytes * (u - 1) // u


def _jax_usp(layout, joint, with_q):
    mesh, u, r = _mesh(layout)
    q, k, v, jq, jk, jv = map(jnp.asarray, _attn_inputs())

    def body(q, k, v, jq, jk, jv):
        kw = {} if joint == "none" else dict(joint_k=jk, joint_v=jv)
        return jusp(q, k, v, ulysses_size=u, ring_size=r, joint_q=jq if with_q else None,
                    joint_strategy=joint, **kw)

    f = jax.shard_map(body, mesh=mesh, in_specs=(SEQ, SEQ, SEQ, P(), P(), P()), out_specs=SEQ,
                      check_vma=False)
    return np.split(np.asarray(jax.jit(f)(q, k, v, jq, jk, jv)), u * r, axis=1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}" + "-fused" * c[2] + "-joint_q" * c[3])
def test_usp_attention_matches_jax(spawned, case):
    """Every rank's output (with a joint query: its joint rows and its own)
    against the JAX shard of its (ring, ulysses) index."""
    layout, joint, _, with_q = case
    ref = _jax_usp(layout, joint, with_q)
    for rank, res in enumerate(spawned):
        got = res["attn"][case]
        assert got.shape == ref[rank].shape
        assert rel_err(got, ref[rank]) < ATTN_REL, rank


@functools.lru_cache(maxsize=None)
def _jax_compact():
    mesh, u, r = _mesh("u2r2")
    cfg = JCompact(enabled=True, compress_type=JType.BINARY, residual=1, error_feedback=True, warmup_steps=0)

    def body(q, k, v, state):
        state = jax.tree_util.tree_map(lambda a: a[0], state)
        out, new = jcompact_usp(q, k, v, state, cfg=cfg, method=cfg.compress_type, ulysses_size=u,
                                ring_size=r)
        return out, jax.tree_util.tree_map(lambda a: a[None], new)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(SEQ, SEQ, SEQ, DEV), out_specs=(SEQ, DEV),
                               check_vma=False))
    n, c = 1 * (S // 4) * u, (H // u) * D
    state = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (4,) + a.shape),
                                   jinit(r, n, c, jnp.float32, 1))
    res = []
    for q, k, v in _steps():
        out, state = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), state)
        res.append((np.split(np.asarray(out), 4, axis=1), [np.asarray(state.k.base), np.asarray(state.v.base)]))
    return res


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_compact_usp_binary_matches_jax(spawned, fused):
    for step, (ref_out, ref_stacks) in enumerate(_jax_compact()):
        for rank, res in enumerate(spawned):
            out, stacks, dev = res["compact"][fused][step]
            assert rel_err(out, ref_out[rank]) < OUT_REL, (step, rank)
            for got, want in zip(stacks, ref_stacks):
                assert got.shape == want[rank].shape == (2, 16, 32)
                assert rel_err(got, want[rank]) < BASE_REL, (step, rank)
            assert dev == 0.0, (step, rank)
            # the ring peers (U global ranks apart) hold the same stacks
            for got, peer in zip(stacks, spawned[(rank + 2) % 4]["compact"][fused][step][1]):
                np.testing.assert_array_equal(got, peer)


GEOMETRY = [("pixart", dict(ulysses_degree=3), {}), ("pixart", dict(ulysses_degree=2, ring_degree=3), {}),
            ("flux", dict(ulysses_degree=8), {}), ("flux", dict(ulysses_degree=2, ring_degree=3), {}),
            ("flux", dict(pp_degree=2, ulysses_degree=2), dict(num_pipeline_patch=3)),
            ("flux", dict(pp_degree=2, ulysses_degree=2), dict(num_pipeline_patch=2))]


@pytest.mark.parametrize("family,par,extra", GEOMETRY, ids=lambda c: str(c))
def test_sp_geometry_errors_match_jax(family, par, extra):
    """The pipelines refuse a Ulysses x ring factorisation that does not
    split the heads, the tokens or the pipeline patches, with the JAX
    package's message."""
    jcls, tcls, jm, tm, size = {
        "pixart": (jpipe.PixArtPipelineConfig, tpipe.PixArtPipelineConfig, jpixart_tiny(), tpix.pixart_tiny(),
                   (64, 64)),
        "flux": (jflux_pipe.FluxPipelineConfig, tflux_pipe.FluxPipelineConfig, jflux_tiny(), tflux.flux_tiny(),
                 (64, 128))}[family]
    kw = dict(height=size[0], width=size[1], **extra)
    with pytest.raises(ValueError) as jerr:
        jcls(model=jm, vae=jtiny_vae(), parallel=JParallel(**par), **kw)
    with pytest.raises(ValueError) as terr:
        tcls(model=tm, vae=tvae.tiny_vae(), parallel=ParallelConfig(**par), **kw)
    assert str(terr.value) == str(jerr.value)


def test_patch_gather_refuses_ulysses_as_jax_does():
    """``patch_gather`` lives on the ring axis: PixArt with Ulysses > 1
    refuses it, as the JAX package's ``_attn_impl`` does; FLUX takes the
    compressed USP (the JAX package routes it there)."""
    compact = dict(enabled=True, patch_gather=True)
    jc = jpipe.PixArtPipelineConfig(model=jpixart_tiny(), vae=jtiny_vae(), height=64, width=64,
                                    parallel=JParallel(ulysses_degree=2), compact=JCompact(**compact))
    tc = tpipe.PixArtPipelineConfig(model=tpix.pixart_tiny(), vae=tvae.tiny_vae(), height=64, width=64,
                                    parallel=ParallelConfig(ulysses_degree=2), compact=CompactConfig(**compact))
    with pytest.raises(AssertionError, match="ulysses_degree=1") as jerr:
        jpipe._attn_impl(jc, JType.BINARY)
    with pytest.raises(AssertionError, match="ulysses_degree=1") as terr:
        tpipe._attn_impl(tc, CompressType.BINARY, None)
    assert str(terr.value) == str(jerr.value)
    fc = tflux_pipe.FluxPipelineConfig(model=tflux.flux_tiny(), vae=tvae.tiny_vae(), height=64, width=128,
                                       parallel=ParallelConfig(ulysses_degree=2, ring_degree=2),
                                       compact=CompactConfig(**compact))
    impl = tflux_pipe._attn_impl(fc, CompressType.BINARY, None)
    assert isinstance(impl, CompactUSPAttn) and impl.ulysses_size == 2
