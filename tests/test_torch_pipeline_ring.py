"""The tiny PixArt pipeline across 4 gloo processes vs the JAX pipeline on a
4-device CPU mesh: cfg 2 x ring 2 (batch 1) and dp 2 x ring 2 (batch 2),
lossless and with the compressed BINARY ring (residual 1 + EF, warmup 1,
spiced params, the consistency check on), unfused and through the fused
ring kernels' twins.  The same noise and text go to JAX ``pipe._sample``
and to every rank of the port; every rank gets the whole latents.

Bounds, as in test_torch_pipeline.py and test_torch_pipeline_codecs.py:
lossless latents within 2e-4 relative; compressed latents within a tenth of
the JAX run's own distance from its lossless latents (a sign at |delta| ~ 0
may flip between the frameworks' fp32 summation orders), which must be > 0.
JAX runs its ppermute ring for the fused configurations too (its fused
kernels take the TPU or interpret mode); the fused and unfused rings
compute the same values.  The EF caches stay identical on the ring's ranks
(deviation 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPipeline
from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err, spice_params
from tests.test_torch_rank_fns import pipeline_latents

STEPS = 4
BOUND = 2e-4
LAYOUTS = {"cfg2xring2": (dict(cfg_degree=2, ring_degree=2), 1),
           "dp2xring2": (dict(dp_degree=2, ring_degree=2), 2)}
BINARY = dict(enabled=True, compress_type="binary", warmup_steps=1, check_consistency=True)
CONFIGS = [(f"{lay}-{codec}" + "-fused" * fused, dict(par, use_fused_ring=fused),
            None if codec == "lossless" else BINARY, batch)
           for lay, (par, batch) in LAYOUTS.items() for codec in ("lossless", "binary")
           for fused in (False, True)]


def _inputs(batch):
    rng = np.random.default_rng(batch)
    text = rng.standard_normal((2, batch, 6, 32)).astype(np.float32)
    mask = np.ones((2, batch, 6), bool)
    mask[1, 0, 4:] = False  # a padded uncond prompt
    return text, mask, rng.standard_normal((batch, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_pixart(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    return jm, jv, jparams, jvae


@pytest.fixture(scope="module")
def spawned(models):
    _, _, jparams, jvae = models
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    inputs = {b: _inputs(b) for b in (1, 2)}
    return tmesh.spawn_local(pipeline_latents, 4, "gloo", CONFIGS, to_np(jparams), to_np(jvae),
                             inputs, threads=1, timeout=300)


@pytest.fixture(scope="module")
def jax_latents(models):
    jm, jv, jparams, jvae = models
    cache = {}

    def run(layout, codec):
        if (layout, codec) not in cache:
            par, batch = LAYOUTS[layout]
            jc = JPipelineConfig(model=jm, vae=jv, parallel=JParallel(**par), num_steps=STEPS,
                                 height=64, width=64,
                                 compact=JCompact(**dict(BINARY, compress_type=JType.BINARY))
                                 if codec == "binary" else JCompact())
            mesh = make_mesh(jc.parallel, devices=jax.devices()[:4])
            pipe = JPipeline(jparams, jvae, jc, mesh)
            cache[(layout, codec)] = np.asarray(pipe._sample(jparams, *map(jnp.asarray, _inputs(batch))))
        return cache[(layout, codec)]

    return run


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_pipeline_across_ranks_matches_jax(spawned, jax_latents, config):
    name, par, compact, batch = config
    layout, codec = name.split("-")[:2]
    ref = jax_latents(layout, codec)
    for rank, res in enumerate(spawned):
        lat, dev = res[name]
        assert lat.shape == (batch, 16, 16)
        if codec == "lossless":
            assert rel_err(lat, ref) < BOUND, rank
        else:
            jax_codec_err = rel_err(ref, jax_latents(layout, "lossless"))
            assert jax_codec_err > 0 and rel_err(lat, res[f"{layout}-lossless"][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_codec_err, rank
            assert dev == 0.0, rank
        # every rank holds the same latents
        np.testing.assert_array_equal(lat, spawned[0][name][0])
