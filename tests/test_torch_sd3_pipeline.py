"""The whole SD3 slice vs the JAX pipeline: sd3_tiny (qk norm on) + tiny_vae
in fp32, 4 flow-match steps (static shift 3) with CFG 7, a 4 x 8 token grid
(64 x 128 px), the same text, pooled vectors and noise fed to JAX
``pipe._sample`` and to the port.

* One process: latents and images within 2e-4 relative (the fp32 backbone
  bound of tests/io/test_backbone_parity.py); the geometry errors are
  JAX's.
* One spawn of 2 gloo processes against JAX's 2-device CPU mesh: ring 2
  lossless unfused and fused, Ulysses 2, cfg 2 and TP 2 within 2e-4 of
  JAX's run of the same configuration and of the port's one process;
  sync PipeFusion pp2 bit-equal to the port's one process; the patch
  pipeline (pp2, M 4, 2 warmup steps) within 2e-4 of JAX's patch pipeline
  and in (1e-6, 0.3) of sync (tests/models/test_sd3.py's bound); the
  compressed BINARY ring (residual 1 + EF, warmup 1, the consistency
  check on), unfused and fused, within a tenth of JAX's own distance from
  its lossless latents (which must be > 0), EF deviation 0.  Every rank
  holds the same latents.
* ``examples/sd3_example.py`` and the HTTP service on ``sd3-tiny``: a
  valid PNG from the prompt, through the SD3 prompt assembly (CLIP-L ++
  CLIP-G, then T5).

The tiny model at its init barely reads its latents (a patch embedding of
std 0.02 against a unit positional table, attention weights of std 0.02
over 64 channels): JAX's BINARY ring then moves the latents by 7e-7, at
the fp32 order floor.  The weights are scaled (:func:`strengthen`) so the
image K/V that the ring compresses counts: the codec moves them by 1e-4.
"""

import base64
import dataclasses
import functools
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.sd3 import init_sd3, sd3_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.sd3 import SD3Pipeline as JPipeline
from compactfusion_tpu.pipelines.sd3 import SD3PipelineConfig as JPipelineConfig
from compactfusion_tpu_torch import args as targs
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.entrypoints.launch import Engine, make_handler
from compactfusion_tpu_torch.examples import sd3_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import sd3 as tsd3
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines.sd3 import SD3Pipeline, SD3PipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_pipefusion import spawn_beside
from tests.test_torch_rank_fns import parallel_pipeline_latents

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
           ("u2", dict(ulysses_degree=2), None, {}, None),
           ("cfg2", dict(cfg_degree=2), None, {}, None),
           ("tp2", dict(tp_degree=2), None, {}, None),
           ("pp2", dict(pp_degree=2), None, {}, None),
           ("pp2-patch", dict(pp_degree=2), None, PATCH, None),
           ("ring2-binary", dict(ring_degree=2), BINARY, {}, "ring2"),
           ("ring2-binary-fused", dict(ring_degree=2, use_fused_ring=True), BINARY, {}, "ring2")]


def inputs():
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((2, 1, 9, 32)).astype(np.float32)
    txt[1] *= 0.3  # an uncond text unlike the cond one
    pooled = rng.standard_normal((2, 1, 16)).astype(np.float32)
    return txt, pooled, rng.standard_normal((1, 32, 16)).astype(np.float32)


def strengthen(params, embed="patch_embed", qkv="img_qkv", out="img_out", blocks=("blocks",)):
    """The patch embedding x30 and the image attention's qkv and output
    projections x4 (spiced modulation biases as well)."""
    params = dict(spice_params(params))
    params[embed] = dict(params[embed], w=params[embed]["w"] * 30)
    for key in blocks:
        b = dict(params[key])
        for name in (qkv, out):
            b[name] = dict(b[name], w=b[name]["w"] * 4)
        params[key] = b
    return params


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(sd3_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    return jm, jv, strengthen(init_sd3(jax.random.PRNGKey(0), jm)), init_vae_decoder(jax.random.PRNGKey(1), jv)


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
        lat = pipe._sample(jp, *map(jnp.asarray, inputs()))
        return np.asarray(lat), np.asarray(pipe._decode(jvae, lat))

    return run


def _port(models, **kw):
    _, _, jp, jvae = models
    to_t = lambda t: params_from_numpy(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    tm = dataclasses.replace(tsd3.sd3_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    return SD3Pipeline(to_t(jp), to_t(jvae), SD3PipelineConfig(model=tm, vae=tv, num_steps=STEPS, **SIZE, **kw), "cpu")


def test_one_process_matches_jax(models, jax_latents):
    jlat, jimg = jax_latents("one")
    pipe = _port(models)
    txt, pooled, noise = (torch.from_numpy(a) for a in inputs())
    lat = pipe(txt, pooled, latents=noise, decode=False)
    img = pipe.decode(lat)
    assert lat.shape == (1, 32, 16) and img.shape == (1, 16, 32, 3)  # the tiny VAE upsamples 2x
    assert rel_err(lat.numpy(), jlat) < BOUND and rel_err(img.numpy(), jimg) < BOUND
    assert 0.0 <= img.min() and img.max() <= 1.0
    a = pipe(txt, pooled, generator=torch.Generator().manual_seed(3))
    b = pipe(txt, pooled, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pipe(txt, pooled)
    # the geometry errors are JAX's, message for message
    for par in (dict(ulysses_degree=3), dict(ring_degree=3), dict(pp_degree=5)):
        with pytest.raises(ValueError) as want:
            JPipelineConfig(model=models[0], vae=models[1], parallel=JParallel(**par), **SIZE)
        with pytest.raises(ValueError) as got:
            SD3PipelineConfig(model=pipe.cfg.model, vae=pipe.cfg.vae, parallel=ParallelConfig(**par), **SIZE)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mesh"):
        SD3Pipeline({}, None, SD3PipelineConfig(model=pipe.cfg.model, vae=pipe.cfg.vae,
                                                parallel=ParallelConfig(ring_degree=2), **SIZE), "cpu")


@pytest.fixture(scope="module")
def spawned(models, jax_latents):
    _, _, jp, jvae = models
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jobs = {"sd3": ({}, [c[:4] for c in CONFIGS], to_np(jp), to_np(jvae), inputs())}
    return spawn_beside(parallel_pipeline_latents, 2, (jobs,), lambda: [jax_latents(c[0]) for c in CONFIGS])


@pytest.mark.parametrize("config", CONFIGS[1:], ids=lambda c: c[0])
def test_across_ranks_matches_jax(spawned, jax_latents, config):
    name, par, compact, extra, twin = config
    ref = jax_latents(name)[0]
    one = spawned[0]["sd3", "one"][0]
    got = [r["sd3", name] for r in spawned]
    for rank, (lat, dev) in enumerate(got):
        assert lat.shape == ref.shape == (1, 32, 16)
        if twin is not None:
            jax_err = rel_err(ref, jax_latents(twin)[0])
            assert jax_err > 0 and rel_err(lat, spawned[0]["sd3", twin][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_err, rank
            assert dev == 0.0, rank
        else:
            assert rel_err(lat, ref) < BOUND, rank
        if name == "pp2":
            np.testing.assert_array_equal(lat, one)
        elif name == "pp2-patch":
            sync = spawned[0]["sd3", "pp2"][0]
            assert PATCH_REL[0] < rel_err(lat, sync) < PATCH_REL[1], rank
        elif twin is None:
            assert rel_err(lat, one) < BOUND, rank
        np.testing.assert_array_equal(lat, got[0][0])


TINY = ["--model", "sd3-tiny", "--height", "64", "--width", "128", "--num_inference_steps", "2",
        "--max_sequence_length", "8", "--guidance_scale", "7.0", "--prompt", "a cat"]


def test_example_and_service_on_the_cpu(tmp_path, monkeypatch):
    from compactfusion_tpu_torch.utils.image import read_png
    from tests.test_torch_api import _http

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sd3_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = sd3_example.main(TINY)
    assert out.shape == (1, 16, 32, 3) and saved == "results/sd3_rank0_0.png"
    assert read_png((tmp_path / saved).read_bytes()).shape == (16, 32, 3)
    assert torch.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0 and out.std() > 0

    parser = targs.FlexibleArgumentParser()
    targs.xFuserArgs.add_cli_args(parser)
    engine = Engine(targs.xFuserArgs.from_cli_args(parser.parse_args(TINY)), serve_batch=1, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        code, r = _http(f"http://127.0.0.1:{server.server_address[1]}/generate", {"prompt": "a dog", "seed": 2})
        assert code == 200 and r["media_type"] == "image/png" and r["shape"] == [1, 16, 32, 3]
        assert base64.b64decode(r["images"][0])[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        server.shutdown()
        engine.close()
