"""The whole FLUX slice vs the JAX pipeline: flux_tiny + tiny_vae, fp32,
4 flow-match steps with embedded guidance, the same noise ``latents0`` fed
to JAX ``pipe._sample`` and to the port.

* One device: latents and images within 2e-4 relative (the fp32 backbone
  bound of tests/io/test_backbone_parity.py).
* Ring 2 across 2 gloo processes against JAX's 2-device CPU mesh: lossless
  within 2e-4, unfused and through the fused ring kernel's twin; the
  compressed BINARY ring (residual 1 + EF, warmup 1, spiced modulation
  biases, the consistency check on) within a tenth of the JAX run's own
  distance from its lossless latents, which must be > 0, as in
  tests/test_torch_pipeline_ring.py (a sign at |delta| ~ 0 may flip between
  the frameworks' fp32 summation orders).  JAX runs its ppermute ring for
  the fused configurations too.  The text rides the ring as joint tensors.
* The branches this slice leaves out raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.flux import flux_tiny, init_flux
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.flux import FluxPipeline as JPipeline
from compactfusion_tpu.pipelines.flux import FluxPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import flux as tflux
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_rank_fns import flux_pipeline_latents

STEPS = 4
BOUND = 2e-4
SIZE = dict(height=64, width=128)  # a 4 x 8 grid: 32 image tokens
BINARY = dict(enabled=True, compress_type="binary", warmup_steps=1, residual=1, error_feedback=True,
              check_consistency=True)
RING2 = dict(ring_degree=2)
CONFIGS = [(f"ring2-{codec}" + "-fused" * fused, dict(RING2, use_fused_ring=fused),
            None if codec == "lossless" else BINARY)
           for codec in ("lossless", "binary") for fused in (False, True)]


def _inputs():
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((1, 8, 32)).astype(np.float32)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    return txt, pooled, rng.standard_normal((1, 32, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(flux_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_flux(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    return jm, jv, jparams, jvae


@pytest.fixture(scope="module")
def jax_run(models):
    jm, jv, jparams, jvae = models
    cache = {}

    def run(parallel, compact=None):
        key = (tuple(sorted(parallel.items())), compact is not None)
        if key not in cache:
            jc = JPipelineConfig(model=jm, vae=jv, parallel=JParallel(**parallel), num_steps=STEPS,
                                 compact=JCompact(**dict(compact, compress_type=JType.BINARY))
                                 if compact else JCompact(), **SIZE)
            n = JParallel(**parallel).world_size
            pipe = JPipeline(jparams, jvae, jc, make_mesh(jc.parallel, devices=jax.devices()[:n]))
            lat = np.asarray(pipe._sample(jparams, *map(jnp.asarray, _inputs())))
            cache[key] = (lat, np.asarray(pipe._decode(jvae, jnp.asarray(lat))))
        return cache[key]

    return run


def _port(models, **kw):
    _, _, jparams, jvae = models
    tm = dataclasses.replace(tflux.flux_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    to_t = lambda t: params_from_numpy(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    cfg = FluxPipelineConfig(model=tm, vae=tv, num_steps=STEPS, **SIZE, **kw)
    return FluxPipeline(to_t(jparams), to_t(jvae), cfg, "cpu")


def test_lossless_flux_slice_matches_jax(models, jax_run):
    jlat, jimg = jax_run({})
    pipe = _port(models)
    txt, pooled, noise = (torch.from_numpy(a) for a in _inputs())
    lat = pipe(txt, pooled, latents=noise, decode=False)
    img = pipe.decode(lat)
    assert lat.shape == (1, 32, 16) and img.shape == (1, 16, 32, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND
    assert rel_err(img.numpy(), jimg) < BOUND
    assert img.min() >= 0.0 and img.max() <= 1.0
    # the generator path: seeded noise, the same image twice
    a = pipe(txt, pooled, generator=torch.Generator().manual_seed(3))
    b = pipe(txt, pooled, generator=torch.Generator().manual_seed(3))
    assert a.shape == (1, 16, 32, 3) and torch.equal(a, b)
    with pytest.raises(ValueError):
        pipe(txt, pooled)


@pytest.fixture(scope="module")
def spawned(models):
    _, _, jparams, jvae = models
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return tmesh.spawn_local(flux_pipeline_latents, 2, "gloo", CONFIGS, to_np(jparams), to_np(jvae),
                             _inputs(), threads=1, timeout=300)


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_flux_ring_across_ranks_matches_jax(spawned, jax_run, config):
    name, par, compact = config
    ref = jax_run(RING2, compact)[0]
    lossless = jax_run(RING2)[0]
    for rank, res in enumerate(spawned):
        lat, dev = res[name]
        assert lat.shape == (1, 32, 16)
        if compact is None:
            assert rel_err(lat, ref) < BOUND, rank
        else:
            jax_codec_err = rel_err(ref, lossless)
            assert jax_codec_err > 0 and rel_err(lat, res["ring2-lossless"][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_codec_err, rank
            assert dev == 0.0, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])
    # the ring-2 lossless run is the one-device run, up to fp32 order
    assert rel_err(jax_run({})[0], lossless) < BOUND


def test_unported_flux_branches_raise(models, spawned):
    tm, tv = tflux.flux_tiny(), tvae.tiny_vae()
    # PipeFusion (sync and patch-pipelined) and TP are ported: the configs
    # build, the pipelines need this rank's mesh
    for kw in (dict(parallel=ParallelConfig(ulysses_degree=2, pp_degree=2)), dict(parallel=ParallelConfig(pp_degree=2)),
               dict(parallel=ParallelConfig(tp_degree=2)),
               dict(parallel=ParallelConfig(pp_degree=2), num_pipeline_patch=4)):
        with pytest.raises(ValueError, match="mesh"):
            FluxPipeline({}, None, FluxPipelineConfig(model=tm, vae=tv, **SIZE, **kw), "cpu")
    with pytest.raises(ValueError, match="mesh"):  # a ring across ranks needs this rank's mesh
        FluxPipeline({}, None, FluxPipelineConfig(model=tm, vae=tv, parallel=ParallelConfig(ring_degree=2),
                                                  **SIZE), "cpu")
    # the cache probes are ported: summed over the ring, every rank skips
    # the same steps (all but the first and the last) and holds the same latents
    for res in spawned:
        skips, lat = res["cache skips"]
        assert skips == 2 and np.isfinite(lat).all()
        np.testing.assert_array_equal(lat, spawned[0]["cache skips"][1])
    pipe = _port(models)
    m = pipe.cfg.model
    args = (torch.zeros(1, 32, 16), torch.zeros(1, 8, 32), torch.zeros(1, 16), torch.full((1,), 500.0),
            torch.full((1,), 3500.0), m)
    rope = dict(img_rope=pipe.img_rope,
                txt_rope=tcm.rope_frequencies(torch.zeros((8, 3), dtype=torch.int64), m.axes_dim))
    with pytest.raises(ValueError, match="mesh"):
        tflux.flux_forward(pipe.params, *args, pp_stages=2, **rope)
    # 2 + 2 blocks divide 2 stages: no padding
    assert tflux.pad_flux_for_pp(pipe.params, m, 2) == (pipe.params, m)
    with pytest.raises(ValueError, match="mesh"):
        tflux.flux_forward(pipe.params, *args, tp_axis="tp", **rope)
