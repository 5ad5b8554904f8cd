"""HunyuanVideo vs the JAX package on the CPU, fp32, ``hunyuanvideo_tiny``
(2 double + 2 single blocks, dim 64, 2 refiner blocks) with spiced
modulation biases, bound 2e-4 (the fp32 bound of tests/io/
test_backbone_parity.py).

* ``init_hunyuanvideo``'s tree; the positions; ``token_refiner`` with a
  padded mask (its masked attention) and without; ``hunyuanvideo_forward``
  with guidance, pooled vector and mask.
* The tiny pipeline (32 x 32, 5 frames: 2 latent frames of 2 x 2 tokens,
  3 flow-match steps at shift 7, embedded guidance, the tiny HV VAE after
  the 2x2 unpacking) against JAX ``pipe._sample`` / ``pipe._decode``, with
  a per-layer two-family plan on the one-device compressed ring (ring 1)
  and ``carry_ef_state``.
* One spawn of 2 gloo processes: U2, ring 2 lossless, fused or not, and
  BINARY (residual 1 + EF, warmup 1), unfused and fused (the fused
  compressed ring: 4 local + 6 text query rows are not a multiple of 8,
  so it takes the unfused route, as JAX's condition says), and sync pp2,
  against JAX on a CPU mesh of the same layout: lossless within 2e-4 of
  JAX's one-device run, pp2 bit-equal to the port's one process, BINARY
  within a tenth of JAX's own distance from its lossless latents; EF caches
  equal on the ring peers.
* ``xDiTParallel`` on ``hunyuanvideo-tiny`` from a prompt against the JAX
  runner; the example.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import hunyuanvideo as jhv
from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.hunyuanvideo import HunyuanVideoPipeline as JPipe
from compactfusion_tpu.pipelines.hunyuanvideo import HunyuanVideoPipelineConfig as JCfg
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.examples import hunyuanvideo_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import hunyuanvideo as thv
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline, HunyuanVideoPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_api import _np
from tests.test_torch_latte import jax_video_runner
from tests.test_torch_rank_fns import port_runner

BOUND = 2e-4
SIZE = dict(height=32, width=32, num_frames=5)


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(jhv.hunyuanvideo_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(jvae3d.tiny_hv_vae3d(), dtype=jnp.float32)
    return jm, spice_params(jhv.init_hunyuanvideo(jax.random.PRNGKey(0), jm)), jv, jvae3d.init_hv_vae3d_decoder(
        jax.random.PRNGKey(1), jv)


def _tm():
    return dataclasses.replace(thv.hunyuanvideo_tiny(), dtype=torch.float32)


def test_init_tree_refiner_and_forward_match_jax(models):
    jm, jp, _, _ = models
    own = thv.init_hunyuanvideo(torch.Generator().manual_seed(0), _tm())
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    np.testing.assert_array_equal(thv.hunyuanvideo_positions(2, 3, 4).numpy(),
                                  np.asarray(jhv.hunyuanvideo_positions(2, 3, 4)))
    tp = params_from_numpy(_np(jp))
    rng = np.random.default_rng(11)
    f, hp, wp = 2, 4, 4
    vid = rng.standard_normal((2, f * hp * wp, 16)).astype(np.float32)
    txt = rng.standard_normal((2, 6, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    t = np.array([212.0, 780.0], np.float32)
    g = np.array([6000.0, 6000.0], np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    for m in (mask, None):
        want = jhv.token_refiner(jp["refiner"], jnp.asarray(txt), jnp.asarray(t), jm,
                                 mask=None if m is None else jnp.asarray(m))
        got = thv.token_refiner(tp["refiner"], torch.from_numpy(txt), torch.from_numpy(t), _tm(),
                                mask=None if m is None else torch.from_numpy(m))
        assert rel_err(got.numpy(), np.asarray(want)) < BOUND
    pos = jhv.hunyuanvideo_positions(f, hp, wp)
    rope_j = jcm.rope_frequencies(pos, jm.axes_dim, theta=256.0)
    txt_j = jcm.rope_frequencies(jnp.zeros((6, 3), jnp.int32), jm.axes_dim, theta=256.0)
    want, _, _ = jhv.hunyuanvideo_forward(jp, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(pooled),
                                          jnp.asarray(t), jnp.asarray(g), jm, video_rope=rope_j, txt_rope=txt_j,
                                          text_mask=jnp.asarray(mask))
    rope_t = tcm.rope_frequencies(thv.hunyuanvideo_positions(f, hp, wp), jm.axes_dim, theta=256.0)
    txt_t = tcm.rope_frequencies(torch.zeros((6, 3), dtype=torch.int64), jm.axes_dim, theta=256.0)
    got, _, _ = thv.hunyuanvideo_forward(tp, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(pooled),
                                         torch.from_numpy(t), torch.from_numpy(g), _tm(), video_rope=rope_t,
                                         txt_rope=txt_t, text_mask=torch.from_numpy(mask))
    assert got.shape == (2, f * hp * wp, 16) and rel_err(got.numpy(), np.asarray(want)) < BOUND


def _plan(step, layer):
    """Per-layer plan over 4 layers (2 double + 2 single): IDENTITY on the
    first double block, BINARY elsewhere."""
    return JType.IDENTITY if layer == 0 else JType.BINARY


@pytest.mark.parametrize("compact", [None, "plan"])
def test_tiny_pipeline_matches_jax(models, compact):
    jm, jp, jv, jvp = models
    ckw = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True)
    jcomp = JCompact(**ckw, compress_func=_plan) if compact else JCompact()
    tcomp = CompactConfig(**ckw, compress_func=lambda s, l: CompressType(_plan(s, l).value)) if compact \
        else CompactConfig()
    jc = JCfg(model=jm, compact=jcomp, num_steps=3, **SIZE)
    jpipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:1]), vae_params=jvp, vae_cfg=jv)
    tv = dataclasses.replace(tvae3d.tiny_hv_vae3d(), dtype=torch.float32)
    cfg = HunyuanVideoPipelineConfig(model=_tm(), vae=tv, compact=tcomp, num_steps=3, **SIZE)
    pipe = HunyuanVideoPipeline(params_from_numpy(_np(jp)), params_from_numpy(_np(jvp)), cfg, "cpu")
    assert cfg.tokens == jc.tokens == 8
    rng = np.random.default_rng(3)
    txt = rng.standard_normal((1, 6, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0]], bool)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 16)).astype(np.float32)
    jlat = np.asarray(jpipe._sample(jp, jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(pooled), jnp.asarray(noise)))
    lat = pipe(torch.from_numpy(txt), torch.from_numpy(pooled), torch.from_numpy(mask),
               latents=torch.from_numpy(noise), decode=False)
    assert lat.shape == jlat.shape == (1, 8, 16) and rel_err(lat.numpy(), jlat) < BOUND
    vid = pipe.decode(lat)
    jvid = np.asarray(jpipe._decode(jvp, jnp.asarray(lat.numpy())))
    assert vid.shape == jvid.shape == (1, 3, 8, 8, 3) and rel_err(vid.numpy(), jvid) < BOUND
    assert 0.0 <= vid.min() and vid.max() <= 1.0


BINARY = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True, check_consistency=True,
              compress_type="binary")
RING2 = dict(ring_degree=2)
CONFIGS = [("u2", dict(ulysses_degree=2), None), ("ring2", RING2, None),
           ("ring2 fused", dict(RING2, use_fused_ring=True), None), ("pp2", dict(pp_degree=2), None),
           ("ring2 binary", RING2, BINARY), ("ring2 binary fused", dict(RING2, use_fused_ring=True), BINARY)]


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((1, 6, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0]], bool)
    return txt, mask, rng.standard_normal((1, 8, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def spawned(models):
    from compactfusion_tpu_torch.parallel import mesh as tmesh
    from tests.test_torch_rank_fns import video_pipeline_latents

    return tmesh.spawn_local(video_pipeline_latents, 2, "gloo", "hunyuanvideo", CONFIGS, _np(models[1]), _inputs(),
                             threads=1, timeout=300)


@pytest.fixture(scope="module")
def jax_latents(models):
    """JAX's final latents at a layout, lossless or BINARY, cached."""
    from compactfusion_tpu.config import ParallelConfig as JParallel

    jm, jp, _, _ = models

    @functools.lru_cache(maxsize=None)
    def run(par_items=(), compact=False):
        jc = JCfg(model=jm, parallel=JParallel(**dict(par_items)), num_steps=3, compact=JCompact(
            **dict(BINARY, compress_type=JType.BINARY)) if compact else JCompact(), **SIZE)
        pipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:jc.parallel.world_size]))
        txt, mask, noise = _inputs()
        return np.asarray(pipe._sample(jp, jnp.asarray(txt), jnp.asarray(mask), jnp.zeros((1, 16), jnp.float32),
                                       jnp.asarray(noise)))

    return run


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_hunyuanvideo_across_ranks_matches_jax(models, spawned, jax_latents, config):
    name, par, compact = config
    one = jax_latents()
    for rank, res in enumerate(spawned):
        lat, dev = res[name]
        assert lat.shape == (1, 8, 16)
        if compact is None:
            assert rel_err(lat, one) < BOUND, rank
        else:
            ref, lossless = jax_latents(tuple(RING2.items()), True), jax_latents(tuple(RING2.items()))
            jax_codec_err = rel_err(ref, lossless)
            assert jax_codec_err > 0 and rel_err(lat, spawned[0]["ring2"][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_codec_err, rank
            assert dev == 0.0, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])
    if name == "pp2":
        tv = dataclasses.replace(tvae3d.tiny_hv_vae3d(), dtype=torch.float32)
        cfg = HunyuanVideoPipelineConfig(model=_tm(), vae=tv, num_steps=3, **SIZE)
        pipe = HunyuanVideoPipeline(params_from_numpy(_np(models[1])), None, cfg, "cpu")
        txt, mask, noise = (torch.from_numpy(a) for a in _inputs())
        np.testing.assert_array_equal(spawned[0][name][0], pipe(txt, None, mask, latents=noise, decode=False).numpy())


TINY = ["--model", "hunyuanvideo-tiny", "--height", "32", "--width", "32", "--num_frames", "5",
        "--num_inference_steps", "2", "--max_sequence_length", "8", "--prompt", "a cat walking", "--seed", "5"]


def test_tiny_runner_matches_jax(tmp_path, monkeypatch):
    jr, weights = jax_video_runner(TINY)
    tr = port_runner(TINY, weights)
    assert tr.family == jr.family == "hunyuanvideo"
    cfg, inp = jr.pipeline_config, jr.input_config
    noise = np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (1, cfg.tokens, 16), jnp.float32))
    jlat, jvid = np.asarray(jr(decode=False)), np.asarray(jr())
    lat, vid = tr(latents=torch.from_numpy(noise), decode=False), tr(latents=torch.from_numpy(noise))
    assert lat.shape == jlat.shape == (1, 8, 16) and vid.shape == jvid.shape == (1, 3, 8, 8, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND and rel_err(vid.numpy(), jvid) < BOUND
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(hunyuanvideo_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = hunyuanvideo_example.main(TINY)
    assert out.shape == (1, 3, 8, 8, 3) and saved == "results/hunyuanvideo_rank0.npy"
