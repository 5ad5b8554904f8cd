"""The port's TeaCache / First-Block-Cache vs the JAX package: the skip
decision helpers, ``pixart_forward`` with a cache, and the whole PixArt slice
(pixart_tiny + tiny_vae, fp32, 4 steps, CFG).

Every threshold here is at least 1e-3 (relative) away from every value it
is compared with (the FBCache probe change, the TeaCache accumulator), and
the tests assert that margin, so a difference in fp32 summation order
cannot flip a decision: a failure is a real disagreement.  Tolerances:
``accum`` and ``prev_probe`` 1e-6 relative (the same fp32 sums); the model
and the pipeline 2e-4 relative, the fp32 backbone bound of
tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.cache import accel as jaccel
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models.pixart import init_pixart, pixart_forward, pixart_tiny, precompute_text_kv
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines import pixart as jpipes
from compactfusion_tpu.schedulers.diffusion import dpm_init_state
from compactfusion_tpu_torch.cache import accel as taccel
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
from tests.helpers import rel_err, spice_params

BOUND = 2e-4
MARGIN = 1e-3
MODES = {
    "fbcache": dict(mode="fbcache"),
    "teacache": dict(mode="teacache"),
    "teacache-flux-poly": dict(mode="teacache", poly=jaccel.FLUX_TEACACHE_POLY),
}


def _margin(values, thr):
    v = np.asarray(values, np.float64)
    return float(np.min(np.abs(v - thr) / thr)) if v.size else np.inf


def _jstate(st, probe, skip, accum, cc):
    return jaccel.CacheAccelState(
        prev_probe=jaccel.next_probe(cc, st, probe, skip), residual=st.residual, accum=accum,
        has_prev=jnp.ones((), jnp.int32), skips=st.skips + skip.astype(jnp.int32))


def _tstate(st, probe, skip, accum, cc):
    return taccel.CacheAccelState(
        prev_probe=taccel.next_probe(cc, st, probe, skip), residual=st.residual, accum=accum,
        has_prev=torch.ones((), dtype=torch.int32), skips=st.skips + skip.to(torch.int32))


def _helper_run(mode, thr, probes):
    """JAX and port helpers over the same probes, the last step forced;
    returns the decisions and the values compared with the threshold."""
    kw = MODES[mode]
    jcc = jaccel.CacheAccelConfig(threshold=thr, **kw)
    tcc = taccel.CacheAccelConfig(threshold=thr, **kw)
    jst = jaccel.init_cache_state(probes[0].shape, (1,), jnp.float32)
    tst = taccel.init_cache_state(probes[0].shape, (1,), torch.float32)
    skips, values = [], []
    for i, p in enumerate(probes):
        force = i == len(probes) - 1
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
        if i > 0:  # the value the threshold decides on
            rel = float(jaccel._rel_l1(jp, jst.prev_probe, ()))
            values.append(rel if kw["mode"] == "fbcache" else
                          float(jst.accum) + float(jnp.polyval(jnp.asarray(jcc.poly, jnp.float32), rel)))
        jskip, jacc = jaccel.should_skip(jcc, jst, jp, force_compute=jnp.asarray(force))
        tskip, tacc = taccel.should_skip(tcc, tst, tp, force_compute=force)
        assert bool(tskip) == bool(jskip), (mode, i)
        np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-6, atol=1e-12)
        jst, tst = _jstate(jst, jp, jskip, jacc, jcc), _tstate(tst, tp, tskip, tacc, tcc)
        np.testing.assert_allclose(tst.prev_probe.numpy(), np.asarray(jst.prev_probe), rtol=1e-6)
        skips.append(bool(jskip))
    assert int(tst.skips) == int(jst.skips) == sum(skips)
    return skips, values


@pytest.mark.parametrize("mode", list(MODES))
def test_should_skip_and_next_probe_match_jax(mode):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    drift = rng.standard_normal((4, 8)).astype(np.float32)
    scale = 0.003 if "flux" in mode else 0.02
    probes = [base + np.float32(scale * (i + 0.3 * (i % 3))) * drift for i in range(12)]
    candidates = np.linspace(0.01, 0.3, 59) if "flux" not in mode else np.linspace(0.05, 1.0, 39)
    best = None
    for thr in candidates:
        skips, values = _helper_run(mode, float(thr), probes)
        if any(skips) and not all(skips[1:]) and _margin(values, thr) > MARGIN:
            best = (thr, skips)
            break
    assert best is not None, mode
    skips = best[1]
    assert not skips[0] and not skips[-1]  # no previous probe; the forced last step


@pytest.fixture(scope="module")
def tiny():
    jm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_pixart(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tvae_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jvae))
    return dict(jm=jm, jv=jv, jparams=jparams, jvae=jvae, tm=tm, tv=tv, tparams=tparams,
                tvae=tvae_params)


@pytest.fixture
def decision_values(monkeypatch):
    """Records, on the port's side, the value each decision of
    ``pixart_forward`` compares with the threshold (steps with a previous
    probe only)."""
    values = []
    real = tpix.should_skip

    def recording(cfg, state, probe, force_compute=None, mesh=None):
        if int(state.has_prev):
            rel = taccel._rel_l1(probe, state.prev_probe, ())
            values.append(float(rel) if cfg.mode == "fbcache"
                          else float(state.accum + taccel._polyval(cfg.poly, rel)))
        return real(cfg, state, probe, force_compute=force_compute, mesh=mesh)

    monkeypatch.setattr(tpix, "should_skip", recording)
    return values


@pytest.mark.parametrize("mode", ["fbcache", "teacache"])
def test_pixart_forward_with_cache_matches_jax(tiny, mode, decision_values):
    """Three steps on moving inputs: computed, skipped, then forced."""
    jm, tm = tiny["jm"], tiny["tm"]
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 16, 16)).astype(np.float32)
    dx = rng.standard_normal((2, 16, 16)).astype(np.float32)
    text = rng.standard_normal((2, 8, jm.text_dim)).astype(np.float32)
    jpos = jcm.sincos_pos_embed_2d(jm.dim, 4, 4, base_size=jm.base_size)
    tpos = tcm.sincos_pos_embed_2d(tm.dim, 4, 4, base_size=tm.base_size)
    thr = 0.12 if mode == "fbcache" else 0.25
    jcc = jaccel.CacheAccelConfig(mode=mode, threshold=thr)
    tcc = taccel.CacheAccelConfig(mode=mode, threshold=thr)
    shp = (2, 16, jm.dim)
    jst = jaccel.init_cache_state(shp, shp, jnp.float32)
    tst = taccel.init_cache_state(shp, shp, torch.float32)
    skips = []
    for i, (eps, t) in enumerate(((0.0, 500.0), (0.01, 480.0), (0.02, 460.0))):
        x = x0 + np.float32(eps) * dx
        force = i == 2
        jout, _, jst = pixart_forward(
            tiny["jparams"], jnp.asarray(x), jnp.full((2,), t), jnp.asarray(text), jm,
            pos_embed=jpos, cache_cfg=jcc, cache_state=jst, cache_force=jnp.asarray(force))
        tout, tattn, tst = tpix.pixart_forward(
            tiny["tparams"], torch.from_numpy(x), torch.full((2,), t), torch.from_numpy(text), tm,
            pos_embed=tpos, cache_cfg=tcc, cache_state=tst, cache_force=force)
        skips.append(int(jst.skips))
        assert tattn == () and int(tst.skips) == int(jst.skips)
        assert rel_err(tout.numpy(), jout) < BOUND
        assert rel_err(tst.residual.numpy(), jst.residual) < BOUND
        np.testing.assert_allclose(float(tst.accum), float(jst.accum), rtol=1e-6, atol=1e-12)
        assert rel_err(tst.prev_probe.numpy(), jst.prev_probe) < BOUND
    assert skips == [0, 1, 1]
    assert len(decision_values) == 2 and _margin(decision_values, thr) > MARGIN, decision_values
    with pytest.raises(ValueError, match="stateful"):
        tpix.pixart_forward(tiny["tparams"], torch.from_numpy(x0), torch.full((2,), 500.0),
                            torch.from_numpy(text), tm, pos_embed=tpos, cache_cfg=tcc,
                            cache_state=tst, attn_state={"x": torch.zeros(1)})


def _jax_cached_latents(tiny, jc, text, mask, latents0):
    """The JAX pipeline's step function driven step by step, so the skip
    count (kept in the cache state, which ``_sample`` does not return) can
    be read; returns (latents, skips)."""
    step, pos, _ = jpipes.denoise_step_fn(jc, None)
    txt = jnp.concatenate([text[0], text[1]], axis=0)
    msk = jnp.concatenate([mask[0], mask[1]], axis=0)
    text_kv = precompute_text_kv(tiny["jparams"], txt).astype(jc.model.dtype)
    shp = (2, jc.tokens, jc.model.dim)
    carry = (latents0, dpm_init_state(latents0.shape), (),
             jaccel.init_cache_state(shp, shp, jnp.float32))
    fn = jax.jit(lambda c, i: step(tiny["jparams"], c, i, txt, msk, pos, text_kv))
    for i in range(jc.num_steps):
        carry = fn(carry, jnp.int32(i))
    return np.asarray(carry[0]), int(carry[3].skips)


@pytest.mark.parametrize("mode", ["fbcache", "teacache"])
def test_whole_slice_with_cache_matches_jax(tiny, mode, decision_values):
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 1, 6, tiny["jm"].text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, 0, 4:] = False
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)
    common = dict(num_steps=4, height=64, width=64)

    def port(thr):
        decision_values.clear()
        tc = PixArtPipelineConfig(model=tiny["tm"], vae=tiny["tv"],
                                  cache=taccel.CacheAccelConfig(mode=mode, threshold=thr), **common)
        pipe = PixArtPipeline(tiny["tparams"], tiny["tvae"], tc, "cpu")
        lat = pipe(torch.from_numpy(text), torch.from_numpy(mask),
                   latents=torch.from_numpy(latents0), decode=False)
        return lat.numpy(), pipe.last_skips, list(decision_values)

    lossless = port(0.0)[0] if mode == "fbcache" else None
    chosen = None
    for thr in np.linspace(0.02, 1.0, 50):
        tlat, tskips, vals = port(float(thr))
        if tskips >= 1 and _margin(vals, thr) > MARGIN:
            chosen = float(thr)
            break
    assert chosen is not None
    jc = jpipes.PixArtPipelineConfig(model=tiny["jm"], vae=tiny["jv"],
                                     cache=jaccel.CacheAccelConfig(mode=mode, threshold=chosen),
                                     **common)
    jlat, jskips = _jax_cached_latents(tiny, jc, jnp.asarray(text), jnp.asarray(mask),
                                       jnp.asarray(latents0))
    mesh = make_mesh(JParallel(), devices=jax.devices()[:1])
    jsample = np.asarray(jpipes.PixArtPipeline(tiny["jparams"], tiny["jvae"], jc, mesh)._sample(
        tiny["jparams"], jnp.asarray(text), jnp.asarray(mask), jnp.asarray(latents0)))
    assert rel_err(jlat, jsample) < 1e-6  # the step-by-step drive is the JAX pipeline
    assert tskips == jskips >= 1
    assert rel_err(tlat, jsample) < BOUND
    if lossless is not None:  # threshold 0 never skips: the lossless run
        base = PixArtPipeline(tiny["tparams"], tiny["tvae"], PixArtPipelineConfig(
            model=tiny["tm"], vae=tiny["tv"], **common), "cpu")
        np.testing.assert_array_equal(lossless, base(
            torch.from_numpy(text), torch.from_numpy(mask), latents=torch.from_numpy(latents0),
            decode=False).numpy())


#: the reason both refusals name
REASON = "block 0 and the rest are not one stage's blocks"


@pytest.mark.parametrize("family", ["pixart", "flux"])
def test_cache_under_pipefusion_refused_with_the_reason(tiny, family):
    """TeaCache/FBCache at pp > 1 stays refused in PixArt and FLUX (the
    model and FLUX's pipeline config), and the message says why."""
    from compactfusion_tpu_torch.config import ParallelConfig
    from compactfusion_tpu_torch.models import flux as tflux
    from compactfusion_tpu_torch.pipelines.flux import FluxPipelineConfig

    cache = taccel.CacheAccelConfig(mode="fbcache")
    if family == "pixart":
        tm = tiny["tm"]
        with pytest.raises(ValueError, match=REASON):
            tpix.pixart_forward(tiny["tparams"], torch.zeros(1, 16, 16), torch.zeros(1), torch.zeros(1, 3, 32), tm,
                                pos_embed=torch.zeros(16, tm.dim), pp_stages=2, mesh=object(), cache_cfg=cache,
                                cache_state=taccel.init_cache_state((1, 16, tm.dim), (1, 16, tm.dim), torch.float32))
        return
    tm = tflux.flux_tiny()
    with pytest.raises(ValueError, match=REASON):
        FluxPipelineConfig(model=tm, vae=tvae.tiny_vae(), parallel=ParallelConfig(pp_degree=2), cache=cache,
                           height=64, width=128)
    with pytest.raises(ValueError, match=REASON):
        tflux.flux_forward({}, torch.zeros(1, 32, 16), torch.zeros(1, 8, 32), torch.zeros(1, 16), torch.zeros(1),
                           None, tm, img_rope=(), txt_rope=(), pp_stages=2, mesh=object(), cache_cfg=cache)


def test_jax_cache_under_pipefusion_leaves_one_stage(tiny):
    """The recorded divergence behind that refusal: under the JAX package's
    PipeFusion the cache branch comes first, each stage runs only its own
    blocks and passes no activations on.  PixArt at pp 2 with FBCache
    (6 steps, threshold 0.05) then leaves pp 1 with the same cache, where
    pp 2 without a cache is pp 1 bit for bit."""
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 1, 6, tiny["jm"].text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, 0, 4:] = False
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)

    def run(pp, mode):
        jc = jpipes.PixArtPipelineConfig(model=tiny["jm"], vae=tiny["jv"], parallel=JParallel(pp_degree=pp),
                                         cache=jaccel.CacheAccelConfig(mode=mode, threshold=0.05), num_steps=6,
                                         height=64, width=64)
        pipe = jpipes.PixArtPipeline(tiny["jparams"], tiny["jvae"], jc,
                                     make_mesh(jc.parallel, devices=jax.devices()[:pp]))
        return np.asarray(pipe._sample(tiny["jparams"], jnp.asarray(text), jnp.asarray(mask), jnp.asarray(latents0)))

    err = rel_err(run(2, "fbcache"), run(1, "fbcache"))
    print(f"JAX PixArt FBCache pp 2 vs pp 1: {err:.3g}")  # the recorded figure (pytest -s)
    assert err > 1e-3
    np.testing.assert_array_equal(run(2, "none"), run(1, "none"))
