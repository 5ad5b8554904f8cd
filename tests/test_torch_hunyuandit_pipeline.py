"""The whole HunyuanDiT slice vs the JAX pipeline: hunyuandit_tiny (2 down +
2 up blocks) + tiny_vae in fp32, 4 DPM-Solver++ steps with CFG 5, a 4 x 8
token grid (64 x 128 px: a non-square rope grid), the same text, padded
masks and noise fed to JAX ``pipe._sample`` and to the port.

* One process: latents and images within 2e-4 relative (the fp32 backbone
  bound of tests/io/test_backbone_parity.py); the geometry errors are
  JAX's.
* One spawn of 2 gloo processes against JAX's 2-device CPU mesh: ring 2
  lossless unfused and fused, cfg 2 and TP 2 within 2e-4 of
  JAX's run of the same configuration and of the port's one process;
  sync PipeFusion pp2 with the mirror skip channel (stage 0's down skips
  to stage 1's up chunk and back, reversed) within 2e-4 of JAX's
  ``hunyuandit_forward(pp_stages=2)`` pipeline and bit-equal to the
  port's one process; the patch pipeline with the skip train (pp2, M 4, 2
  warmup steps) within 2e-4 of JAX's and in (1e-6, 0.3) of sync
  (tests/models/test_hunyuandit.py's bound); the
  compressed BINARY ring (residual 1 + EF, warmup 1, the consistency
  check on), unfused and fused, within a tenth of JAX's own distance from
  its lossless latents (which must be > 0), EF deviation 0.  Every rank
  holds the same latents.

``examples/hunyuandit_example.py`` on ``hunyuandit-tiny`` and
``examples/pixartsigma_example.py`` on ``pixart-tiny`` with
``--enable_tiling`` write valid PNGs.

The weights are scaled as in tests/test_torch_sd3_pipeline.py
(``strengthen``), so that the image K/V the ring compresses counts.
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
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.hunyuandit import hunyuandit_tiny, init_hunyuandit
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.hunyuandit import HunyuanDiTPipeline as JPipeline
from compactfusion_tpu.pipelines.hunyuandit import HunyuanDiTPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.examples import hunyuandit_example, pixartsigma_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import hunyuandit as thy
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines.hunyuandit import HunyuanDiTPipeline, HunyuanDiTPipelineConfig
from tests.helpers import rel_err
from tests.test_torch_pipefusion import spawn_beside
from tests.test_torch_rank_fns import parallel_pipeline_latents
from tests.test_torch_sd3_pipeline import strengthen

STEPS = 4
BOUND = 2e-4
PATCH_REL = (1e-6, 0.3)
SIZE = dict(height=64, width=128)
BINARY = dict(enabled=True, compress_type="binary", warmup_steps=1, residual=1, error_feedback=True,
              check_consistency=True)
PATCH = dict(num_pipeline_patch=4, runtime_warmup_steps=2)
# (name, ParallelConfig kwargs, CompactConfig kwargs, pipeline kwargs, lossless twin)
CONFIGS = [("one", {}, None, {}, None),
           ("ring2", dict(ring_degree=2), None, {}, None),
           ("ring2-fused", dict(ring_degree=2, use_fused_ring=True), None, {}, None),
           ("cfg2", dict(cfg_degree=2), None, {}, None),
           ("tp2", dict(tp_degree=2), None, {}, None),
           ("pp2", dict(pp_degree=2), None, {}, None),
           ("pp2-patch", dict(pp_degree=2), None, PATCH, None),
           ("ring2-binary", dict(ring_degree=2), BINARY, {}, "ring2"),
           ("ring2-binary-fused", dict(ring_degree=2, use_fused_ring=True), BINARY, {}, "ring2")]


def inputs():
    rng = np.random.default_rng(1)
    text = rng.standard_normal((2, 1, 9, 32)).astype(np.float32)
    text[1] *= 0.3  # an uncond text unlike the cond one
    mask = np.ones((2, 1, 9), bool)
    mask[1, 0, 5:] = False  # a padded uncond prompt
    return text, mask, rng.standard_normal((1, 32, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(hunyuandit_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jp = strengthen(init_hunyuandit(jax.random.PRNGKey(0), jm), qkv="attn_qkv", out="attn_out",
                    blocks=("down_blocks", "up_blocks"))
    return jm, jv, jp, init_vae_decoder(jax.random.PRNGKey(1), jv)


@pytest.fixture(scope="module")
def jax_latents(models):
    jm, jv, jp, jvae = models

    @functools.lru_cache(maxsize=None)
    def run(name):
        _, par, compact, extra, _ = {c[0]: c for c in CONFIGS}[name]
        ckw = JCompact(**dict(compact, compress_type=JType.BINARY)) if compact else JCompact()
        jc = JPipelineConfig(model=jm, vae=jv, parallel=JParallel(**par), compact=ckw, num_steps=STEPS, **SIZE,
                             **extra)
        pipe = JPipeline(jp, jvae, jc, make_mesh(jc.parallel, devices=jax.devices()[:jc.parallel.world_size]))
        return np.asarray(pipe._sample(jp, *map(jnp.asarray, inputs())))

    return run


def _port(models, **kw):
    _, _, jp, jvae = models
    to_t = lambda t: params_from_numpy(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    tm = dataclasses.replace(thy.hunyuandit_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    return HunyuanDiTPipeline(to_t(jp), to_t(jvae), HunyuanDiTPipelineConfig(model=tm, vae=tv, num_steps=STEPS,
                                                                             **SIZE, **kw), "cpu")


def test_one_process_matches_jax(models, jax_latents):
    jlat = jax_latents("one")
    pipe = _port(models)
    text, mask, noise = (torch.from_numpy(a) for a in inputs())
    lat = pipe(text, mask, latents=noise, decode=False)
    img = pipe.decode(lat)
    assert lat.shape == (1, 32, 16) and img.shape == (1, 16, 32, 3)  # the tiny VAE upsamples 2x
    assert rel_err(lat.numpy(), jlat) < BOUND
    # JAX's decode of the same latents
    from compactfusion_tpu.models import common as jcm
    from compactfusion_tpu.models.vae import vae_decode

    decode = jax.jit(vae_decode, static_argnums=2)
    jimg = np.clip(np.asarray(decode(models[3], jcm.unpatchify(jnp.asarray(jlat), 2, 4, 8, 4), models[1])) * 0.5 + 0.5,
                   0.0, 1.0)
    assert rel_err(img.numpy(), jimg) < BOUND
    assert 0.0 <= img.min() and img.max() <= 1.0
    a = pipe(text, mask, generator=torch.Generator().manual_seed(3))
    b = pipe(text, mask, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pipe(text, mask)
    # the geometry errors are JAX's, message for message
    for par in (dict(ulysses_degree=3), dict(ring_degree=3), dict(pp_degree=3)):
        with pytest.raises(ValueError) as want:
            JPipelineConfig(model=models[0], vae=models[1], parallel=JParallel(**par), **SIZE)
        with pytest.raises(ValueError) as got:
            HunyuanDiTPipelineConfig(model=pipe.cfg.model, vae=pipe.cfg.vae, parallel=ParallelConfig(**par), **SIZE)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mesh"):
        HunyuanDiTPipeline({}, None, HunyuanDiTPipelineConfig(model=pipe.cfg.model, vae=pipe.cfg.vae,
                                                              parallel=ParallelConfig(ring_degree=2), **SIZE), "cpu")


@pytest.fixture(scope="module")
def spawned(models, jax_latents):
    _, _, jp, jvae = models
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jobs = {"hunyuandit": ({}, [c[:4] for c in CONFIGS], to_np(jp), to_np(jvae), inputs())}
    return spawn_beside(parallel_pipeline_latents, 2, (jobs,), lambda: [jax_latents(c[0]) for c in CONFIGS])


@pytest.mark.parametrize("config", CONFIGS[1:], ids=lambda c: c[0])
def test_across_ranks_matches_jax(spawned, jax_latents, config):
    name, par, compact, extra, twin = config
    ref = jax_latents(name)
    one = spawned[0]["hunyuandit", "one"][0]
    got = [r["hunyuandit", name] for r in spawned]
    for rank, (lat, dev) in enumerate(got):
        assert lat.shape == ref.shape == (1, 32, 16)
        if twin is not None:
            jax_err = rel_err(ref, jax_latents(twin))
            assert jax_err > 0 and rel_err(lat, spawned[0]["hunyuandit", twin][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_err, rank
            assert dev == 0.0, rank
        else:
            assert rel_err(lat, ref) < BOUND, rank
        if name == "pp2":
            np.testing.assert_array_equal(lat, one)
        elif name == "pp2-patch":
            sync = spawned[0]["hunyuandit", "pp2"][0]
            assert PATCH_REL[0] < rel_err(lat, sync) < PATCH_REL[1], rank
        elif twin is None:
            assert rel_err(lat, one) < BOUND, rank
        np.testing.assert_array_equal(lat, got[0][0])


@pytest.mark.parametrize("example,argv,prefix,shape", [
    (hunyuandit_example, ["--model", "hunyuandit-tiny", "--height", "64", "--width", "128"], "hunyuandit",
     (1, 16, 32, 3)),
    (pixartsigma_example, ["--model", "pixart-tiny", "--height", "64", "--width", "64", "--enable_tiling",
                           "--no_use_resolution_binning"], "pixart_sigma", (1, 16, 16, 3))])
def test_example_on_the_cpu(tmp_path, monkeypatch, example, argv, prefix, shape):
    from compactfusion_tpu_torch.utils.image import read_png

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = example.main(argv + ["--num_inference_steps", "2", "--max_sequence_length", "8", "--prompt", "a"])
    assert tuple(out.shape) == shape and saved == f"results/{prefix}_rank0_0.png"
    assert read_png((tmp_path / saved).read_bytes()).shape == shape[1:]
    assert torch.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0 and out.std() > 0
