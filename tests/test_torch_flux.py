"""The port's FLUX pieces vs the JAX package: the common helpers (RoPE,
rmsnorm, the pooled-vector embedder, image positions) at 1e-6, the
``init_flux`` tree, ``flux_forward`` on the same fp32 ``flux_tiny`` weights
(carried by ``params_from_numpy``) with guidance on and off, with FBCache
and TeaCache, the fused and generic single-block routes, the flow-match
schedule and step, the two-family compression segments and ``flux_vae``.

Model bounds are 2e-4 relative: the fp32 bound of
tests/io/test_backbone_parity.py; the two frameworks differ only in fp32
summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.cache import accel as jaccel
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import flux as jflux
from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu.pipelines import base as jbase
from compactfusion_tpu.schedulers import flow_match as jfm
from compactfusion_tpu_torch.cache import accel as taccel
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import flux as tflux
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.pipelines import base as tbase
from compactfusion_tpu_torch.schedulers import flow_match as tfm
from tests.helpers import rel_err, spice_params

BOUND = 2e-4
HELPER_TOL = 1e-6


def _np(t):
    return np.asarray(t)


@pytest.fixture(scope="module")
def tiny():
    out = {}
    for guidance in (True, False):
        jm = dataclasses.replace(jflux.flux_tiny(), dtype=jnp.float32, guidance_embeds=guidance)
        tm = dataclasses.replace(tflux.flux_tiny(), dtype=torch.float32, guidance_embeds=guidance)
        jparams = spice_params(jflux.init_flux(jax.random.PRNGKey(0), jm))
        out[guidance] = (jm, tm, jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)))
    return out


def _inputs(m, b=2, hp=4, wp=4, s_txt=8, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, hp * wp, m.in_channels)).astype(np.float32)
    txt = rng.standard_normal((b, s_txt, m.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((b, m.pooled_dim)).astype(np.float32)
    return img, txt, pooled


def _ropes(jm, hp=4, wp=4, s_txt=8):
    """(JAX, port) (img_rope, txt_rope) tables."""
    jpos = jflux.flux_image_positions(hp, wp)
    jr = (jcm.rope_frequencies(jpos, jm.axes_dim), jcm.rope_frequencies(jnp.zeros((s_txt, 3), jnp.int32), jm.axes_dim))
    tpos = tflux.flux_image_positions(hp, wp)
    tr = (tcm.rope_frequencies(tpos, jm.axes_dim),
          tcm.rope_frequencies(torch.zeros((s_txt, 3), dtype=torch.int64), jm.axes_dim))
    return jr, tr


def test_rope_and_norm_helpers_match_jax():
    rng = np.random.default_rng(0)
    for hp, wp in ((4, 4), (3, 5)):
        jpos, tpos = jflux.flux_image_positions(hp, wp), tflux.flux_image_positions(hp, wp)
        np.testing.assert_array_equal(tpos.numpy(), _np(jpos))
        np.testing.assert_array_equal(tcm.patch_positions_2d(hp, wp).numpy(), _np(jcm.patch_positions_2d(hp, wp)))
        for axes in ((4, 6, 6), (16, 56, 56)):
            jc, js = jcm.rope_frequencies(jpos * 7, axes)
            tc, ts = tcm.rope_frequencies(tpos * 7, axes)
            np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=0, atol=HELPER_TOL)
            np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=HELPER_TOL)
    jc, js = jcm.rope_frequencies(jflux.flux_image_positions(4, 4), (4, 6, 6))
    tc, ts = tcm.rope_frequencies(tflux.flux_image_positions(4, 4), (4, 6, 6))
    x = rng.standard_normal((2, 16, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(tcm.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
                               _np(jcm.apply_rope(jnp.asarray(x), jc, js)), rtol=0, atol=HELPER_TOL)
    jcf, jsf = jcm.rope_half_tables(jc, js)
    tcf, tsf = tcm.rope_half_tables(tc, ts)
    np.testing.assert_allclose(tcf.numpy(), _np(jcf), rtol=0, atol=HELPER_TOL)
    np.testing.assert_allclose(tcm.apply_rope_half(torch.from_numpy(x), tcf, tsf).numpy(),
                               _np(jcm.apply_rope_half(jnp.asarray(x), jcf, jsf)), rtol=0, atol=HELPER_TOL)
    for dh in (16, 128):
        np.testing.assert_array_equal(tcm.rope_half_perm(dh), jcm.rope_half_perm(dh))
    # the interleaved rope on permuted channels is the rotate-half rope
    perm = tcm.rope_half_perm(16)
    inter = tcm.apply_rope(torch.from_numpy(x), tc, ts)[..., perm]
    half = tcm.apply_rope_half(torch.from_numpy(x[..., perm]), tcf, tsf)
    np.testing.assert_allclose(half.numpy(), inter.numpy(), rtol=0, atol=HELPER_TOL)

    g = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
    for p_j, p_t in (({"g": jnp.asarray(g)}, {"g": torch.from_numpy(g)}), ({}, {})):
        np.testing.assert_allclose(tcm.rmsnorm(p_t, torch.from_numpy(x)).numpy(),
                                   _np(jcm.rmsnorm(p_j, jnp.asarray(x))), rtol=0, atol=HELPER_TOL)
    xb = (rng.standard_normal((2, 5, 16)) * 3).astype(np.float32)
    out = tcm.rmsnorm({"g": torch.from_numpy(g).to(torch.bfloat16)}, torch.from_numpy(xb).to(torch.bfloat16))
    ref = jcm.rmsnorm({"g": jnp.asarray(g, jnp.bfloat16)}, jnp.asarray(xb, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))

    emb = {"fc1": {"w": rng.standard_normal((16, 32)).astype(np.float32) * 0.2,
                   "b": rng.standard_normal(32).astype(np.float32)},
           "fc2": {"w": rng.standard_normal((32, 32)).astype(np.float32) * 0.2,
                   "b": rng.standard_normal(32).astype(np.float32)}}
    v = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_allclose(tcm.mlp_embedder(params_from_numpy(emb), torch.from_numpy(v)).numpy(),
                               _np(jcm.mlp_embedder(jax.tree_util.tree_map(jnp.asarray, emb), jnp.asarray(v))),
                               rtol=HELPER_TOL, atol=HELPER_TOL)


@pytest.mark.parametrize("guidance", [True, False])
def test_init_flux_tree_matches_jax(guidance):
    jm = dataclasses.replace(jflux.flux_tiny(), guidance_embeds=guidance)
    tm = dataclasses.replace(tflux.flux_tiny(), guidance_embeds=guidance)
    jp = jax.eval_shape(lambda k: jflux.init_flux(k, jm), jax.random.PRNGKey(0))
    tp = tflux.init_flux(torch.Generator().manual_seed(0), tm)
    shapes_j = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    shapes_t = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert shapes_t == shapes_j
    # the modulation biases start at 0, as in JAX (AdaLN-Zero)
    assert not tp["double_blocks"]["img_mod"]["b"].any() and tp["double_blocks"]["img_qkv"]["w"].std() > 0


def test_params_from_numpy_carries_the_flux_tree():
    """The JAX bf16 FLUX tree, both stacked block families included, comes
    over with its structure and bits."""
    jp = jflux.init_flux(jax.random.PRNGKey(1), jflux.flux_tiny())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    for t, j in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    assert tp["single_blocks"]["mlp"]["fc1"]["w"].shape[0] == 2  # the stacked layer axis


@pytest.mark.parametrize("guidance", [True, False])
def test_flux_forward_matches_jax(tiny, guidance):
    jm, tm, jparams, tparams = tiny[guidance]
    img, txt, pooled = _inputs(jm)
    t = np.asarray([311.0, 820.0], np.float32)
    g = np.asarray([3500.0, 3500.0], np.float32) if guidance else None
    (jir, jtr), (tir, ttr) = _ropes(jm)
    ref, _, _ = jflux.flux_forward(jparams, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pooled),
                                   jnp.asarray(t), None if g is None else jnp.asarray(g), jm,
                                   img_rope=jir, txt_rope=jtr)
    out, sd, ss = tflux.flux_forward(tparams, torch.from_numpy(img), torch.from_numpy(txt),
                                     torch.from_numpy(pooled), torch.from_numpy(t),
                                     None if g is None else torch.from_numpy(g), tm, img_rope=tir, txt_rope=ttr)
    assert out.shape == (2, 16, jm.in_channels) and sd == () and ss == ()
    assert rel_err(out.numpy(), ref) < BOUND
    temb = tflux.flux_time_embed(tparams, torch.from_numpy(pooled), torch.from_numpy(t),
                                 None if g is None else torch.from_numpy(g), tm)
    jtemb = jflux.flux_time_embed(jparams, jnp.asarray(pooled), jnp.asarray(t),
                                  None if g is None else jnp.asarray(g), jm)
    assert rel_err(temb.numpy(), jtemb) < BOUND
    if guidance:
        with pytest.raises(ValueError, match="guidance"):
            tflux.flux_forward(tparams, torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(pooled),
                               torch.from_numpy(t), None, tm, img_rope=tir, txt_rope=ttr)


class _GenericGate(SingleDeviceAttn):
    """Not the exact type ``SingleDeviceAttn``: takes the generic route."""


def test_flux_single_scan_fused_matches_generic(tiny):
    jm, tm, _, tparams = tiny[True]
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.standard_normal((2, 16, jm.dim)).astype(np.float32))
    txt = torch.from_numpy(rng.standard_normal((2, 8, jm.dim)).astype(np.float32))
    temb = torch.from_numpy(rng.standard_normal((2, jm.dim)).astype(np.float32))
    _, (tir, ttr) = _ropes(jm)
    runs = [tflux.flux_single_scan(tparams["single_blocks"], img, txt, temb, tm, img_rope=tir, txt_rope=ttr,
                                   attn=attn) for attn in (SingleDeviceAttn(), _GenericGate())]
    (i_fast, t_fast, _), (i_ref, t_ref, _) = runs
    assert rel_err(i_fast.numpy(), i_ref.numpy()) < 1e-6
    assert rel_err(t_fast.numpy(), t_ref.numpy()) < 1e-6
    # and both are the JAX single scan
    jm_, _, jparams, _ = tiny[True]
    (jir, jtr), _ = _ropes(jm)
    ji, jt, _ = jflux.flux_single_scan(jparams["single_blocks"], jnp.asarray(img.numpy()),
                                       jnp.asarray(txt.numpy()), jnp.asarray(temb.numpy()), jm_,
                                       img_rope=jir, txt_rope=jtr)
    assert rel_err(i_fast.numpy(), ji) < BOUND and rel_err(t_fast.numpy(), jt) < BOUND


@pytest.mark.parametrize("mode,threshold,skips", [("fbcache", 0.0, [0, 0, 0]), ("fbcache", 1e6, [0, 1, 1]),
                                                   ("teacache", 0.0, [0, 0, 0]), ("teacache", 1e6, [0, 1, 1])])
def test_flux_forward_with_cache_matches_jax(tiny, mode, threshold, skips):
    """Three steps on moving inputs (computed, then skipped or not, then
    forced at the last): out, the cache state and the skip count."""
    jm, tm, jparams, tparams = tiny[True]
    img, txt, pooled = _inputs(jm)
    dx = np.random.default_rng(5).standard_normal(img.shape).astype(np.float32)
    (jir, jtr), (tir, ttr) = _ropes(jm)
    jcc = jaccel.CacheAccelConfig(mode=mode, threshold=threshold, poly=jaccel.FLUX_TEACACHE_POLY)
    tcc = taccel.CacheAccelConfig(mode=mode, threshold=threshold, poly=taccel.FLUX_TEACACHE_POLY)
    shp = (2, 16, jm.dim)
    jst = jaccel.init_cache_state(shp, shp, jnp.float32)
    tst = taccel.init_cache_state(shp, shp, torch.float32)
    g = np.full((2,), 3500.0, np.float32)
    got = []
    for i, (eps, t) in enumerate(((0.0, 900.0), (0.01, 880.0), (0.02, 860.0))):
        x = img + np.float32(eps) * dx
        force = i == 2
        tt = np.full((2,), t, np.float32)
        jout, _, _, jst = jflux.flux_forward(
            jparams, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(pooled), jnp.asarray(tt), jnp.asarray(g), jm,
            img_rope=jir, txt_rope=jtr, cache_cfg=jcc, cache_state=jst, cache_force=jnp.asarray(force))
        tout, sd, ss, tst = tflux.flux_forward(
            tparams, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(pooled), torch.from_numpy(tt),
            torch.from_numpy(g), tm, img_rope=tir, txt_rope=ttr, cache_cfg=tcc, cache_state=tst,
            cache_force=force)
        got.append(int(tst.skips))
        assert sd == () and ss == () and int(tst.skips) == int(jst.skips)
        assert rel_err(tout.numpy(), jout) < BOUND
        assert rel_err(tst.residual.numpy(), jst.residual) < BOUND
        assert rel_err(tst.prev_probe.numpy(), jst.prev_probe) < BOUND
        np.testing.assert_allclose(float(tst.accum), float(jst.accum), rtol=1e-5, atol=1e-12)
    assert got == skips
    with pytest.raises(ValueError, match="stateful"):
        tflux.flux_forward(tparams, torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(pooled),
                           torch.full((2,), 500.0), torch.from_numpy(g), tm, img_rope=tir, txt_rope=ttr,
                           cache_cfg=tcc, cache_state=tst, attn_state_double={"x": torch.zeros(1)})


@pytest.mark.parametrize("steps", [4, 28])
@pytest.mark.parametrize("tokens", [32, 4096])
def test_flow_match_schedule_and_step_match_jax(steps, tokens):
    mu = tfm.calculate_shift(tokens)
    assert mu == jfm.calculate_shift(tokens)
    kw = dict(use_dynamic_shifting=True, mu=mu, final_sigma=1.0 / steps)
    js, ts = jfm.flow_match_schedule(steps, **kw), tfm.flow_match_schedule(steps, **kw)
    for a, b in ((ts.sigmas, js.sigmas), (ts.timesteps, js.timesteps)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=HELPER_TOL, atol=0)
    js3, ts3 = jfm.flow_match_schedule(steps, shift=3.0), tfm.flow_match_schedule(steps, shift=3.0)
    np.testing.assert_allclose(ts3.sigmas.numpy(), _np(js3.sigmas), rtol=HELPER_TOL, atol=0)
    rng = np.random.default_rng(steps + tokens)
    x = rng.standard_normal((1, 8, 4)).astype(np.float32)
    v = rng.standard_normal((1, 8, 4)).astype(np.float32)
    for i in (0, steps // 2, steps - 1):
        out = tfm.flow_match_step(ts, i, torch.from_numpy(x), torch.from_numpy(v).to(torch.bfloat16))
        ref = jfm.flow_match_step(js, i, jnp.asarray(x), jnp.asarray(v, jnp.bfloat16))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=HELPER_TOL, atol=HELPER_TOL)
        np.testing.assert_allclose(tfm.flow_match_scale_noise(ts, i, torch.from_numpy(x), torch.from_numpy(v)).numpy(),
                                   _np(jfm.flow_match_scale_noise(js, i, jnp.asarray(x), jnp.asarray(v))),
                                   rtol=HELPER_TOL, atol=HELPER_TOL)
    with pytest.raises(ValueError):
        tfm.flow_match_schedule(steps, use_dynamic_shifting=True)


def _plan(layer, step):
    if step < 2:
        return "warmup"
    if layer in (0, 3):
        return "identity"
    return "int2" if layer < 5 else "binary"


@pytest.mark.parametrize("with_plan", [False, True])
def test_compact_two_family_segments_match_jax(with_plan):
    kw = dict(enabled=True, warmup_steps=2, compress_type="binary")
    jf = (lambda l, s: JType(_plan(l, s))) if with_plan else None
    tf = (lambda l, s: CompressType(_plan(l, s))) if with_plan else None
    jc = JCompact(**dict(kw, compress_type=JType.BINARY), compress_func=jf)
    tc = CompactConfig(**dict(kw, compress_type=CompressType.BINARY), compress_func=tf)

    def plain(segments):  # CompressType -> its value, recursively
        if isinstance(segments, (list, tuple)):
            return type(segments)(plain(s) for s in segments)
        return getattr(segments, "value", segments)

    for n_first, n_second in ((3, 5), (4, 4)):
        j = jbase.compact_two_family_segments(jc, 6, n_first, n_second)
        t = tbase.compact_two_family_segments(tc, 6, n_first, n_second)
        assert plain(t) == plain(j)
        assert plain(tbase.compact_layer_segments(tc, 6, n_first + n_second)) == plain(
            jbase.compact_layer_segments(jc, 6, n_first + n_second))
    off = tbase.compact_two_family_segments(CompactConfig(), 3, 2, 2)
    assert off == jbase.compact_two_family_segments(JCompact(), 3, 2, 2) == [(None, [0, 1, 2])]


def test_flux_vae_matches_jax():
    j, t = jvae.flux_vae(), tvae.flux_vae()
    fields = {f.name for f in dataclasses.fields(t)} - {"dtype"}
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    assert (t.latent_channels, t.scaling_factor, t.shift_factor) == (16, 0.3611, 0.1159)


# ---------------------------------------------------------------------------
# FLUX records: the sparse codec on the relayouted K; the EF-cache bytes
# ---------------------------------------------------------------------------


def test_sparse_codec_on_relayouted_flux_k_matches_jax():
    """``encode_sparse``/``sim_sparse`` (1:8) on FLUX's K (24 heads of 128)
    after the rope relayout (``rope_half_perm``, the converters' head-dim
    order): bit-equal to JAX's codec on JAX's relayouted K.  The payload
    differs from the one for the interleaved layout, since the relayout
    moves each rope pair's channels (j, j+1) to j/2 and 64 + j/2 and so
    changes the 8-channel groups (docs/PERF.md:151-158)."""
    from compactfusion_tpu.compact import codecs as jcodecs
    from compactfusion_tpu_torch.compact import codecs as tcodecs

    cfg = tflux.flux_dev()
    heads, dh = cfg.heads, cfg.dim // cfg.heads
    rng = np.random.default_rng(7)
    k = (rng.standard_normal((256, heads, dh)) * rng.uniform(0.2, 2.0, dh)).astype(np.float32)
    perm = tcm.rope_half_perm(dh)
    np.testing.assert_array_equal(perm, jcm.rope_half_perm(dh))
    k_t = torch.from_numpy(k)[..., torch.from_numpy(perm)].reshape(256, heads * dh)
    k_j = jnp.take(jnp.asarray(k), jnp.asarray(jcm.rope_half_perm(dh)), axis=-1).reshape(256, heads * dh)
    got, want = tcodecs.encode_sparse(k_t, 8), jcodecs.encode_sparse(k_j, 8)
    np.testing.assert_array_equal(got.values.float().numpy(), np.asarray(want.values, np.float32))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(tcodecs.sim_sparse(k_t, 8).numpy(), np.asarray(jcodecs.sim_sparse(k_j, 8)))
    plain = tcodecs.encode_sparse(torch.from_numpy(k).reshape(256, heads * dh), 8)
    assert not torch.equal(plain.indices, got.indices)
    assert not torch.equal(plain.values.float().sort(dim=-1).values, got.values.float().sort(dim=-1).values)


def _ring8_ef_bytes(heads, head_dim, layers, tokens, quantized):
    """Bytes of one rank's EF caches at ring 8 (K and V, every layer), from
    ``CompactUSPAttn.init_state`` on the meta device."""
    from compactfusion_tpu_torch.models.attn_impl import CompactUSPAttn
    from compactfusion_tpu_torch.parallel import mesh as tmesh

    ring = 8
    par = tmesh.ParallelConfig(ring_degree=ring)
    mesh = tmesh.Mesh(par, 0, None, {tmesh.AXIS_RING: 0}, {tmesh.AXIS_RING: None},
                      {tmesh.AXIS_RING: list(range(ring))})
    strategy = CompactUSPAttn(CompactConfig(enabled=True, quantized_cache=quantized), CompressType.BINARY, mesh)
    state = strategy.init_state(layers, 1, tokens // ring, heads, head_dim, torch.bfloat16, device="meta")
    return sum(t.numel() * t.element_size() for t in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("model", ["flux-1024", "cogvideox-49f"])
def test_ring8_ef_cache_bytes_match_the_records(model):
    """Per-device EF-cache bytes at ring 8 against docs/PERF.md:320-326:
    FLUX.1-dev at 1024 px (57 layers, 4,096 image tokens; the text rows are
    never cached) 2.87 GB in bf16 and 1.45 GB with int8 caches;
    CogVideoX-5B at 49 frames (42 layers, 17,550 tokens, 2,193 a rank, B 1
    a rank) 9.05 GB and 4.54 GB."""
    from compactfusion_tpu_torch.models import cogvideox as tcog

    if model == "flux-1024":
        cfg = tflux.flux_dev()
        dims = (cfg.heads, cfg.dim // cfg.heads, cfg.double_layers + cfg.single_layers, (1024 // 16) ** 2)
        want = (2.87, 1.45)
    else:
        cfg = tcog.cogvideox_5b()
        dims = (cfg.heads, cfg.dim // cfg.heads, cfg.depth, 13 * (480 // 16) * (720 // 16))
        want = (9.05, 4.54)
    got = tuple(round(_ring8_ef_bytes(*dims, quantized=q) / 1e9, 2) for q in (False, True))
    assert got == want
