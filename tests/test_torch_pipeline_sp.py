"""The tiny PixArt and FLUX pipelines with Ulysses, hybrid USP, the
patch-parallel gather and the cache probes across 4 gloo processes, vs JAX
``pipe._sample`` on a 4-device CPU mesh (fp32, 4 steps, the same text and
noise; every rank gets the whole latents).

PixArt: Ulysses 2 x ring 2, lossless and BINARY (residual 1 + EF, warmup
1, the consistency check on), each unfused and through the fused ring
kernels' twins; Ulysses 2 x cfg 2; Ulysses 4; ``patch_gather`` at ring 4:
sync, BINARY and DistriFusion's async (IDENTITY, no EF, as
``tests/models/test_pixart.py::test_patch_parallel_pipeline`` runs it);
FBCache at dp 2 x ring 2 with thresholds 0 and 1e6 (the probe summed over
the ring).  FLUX: Ulysses 2 x ring 2 lossless and BINARY, and
``patch_gather=True``, which both packages run as the compressed USP.

Bounds, as in test_torch_pipeline_ring.py: lossless latents (the sync
gather and FBCache among them) within 2e-4 relative; compressed and stale
latents within a tenth of the JAX run's own distance from its lossless
latents, which must be > 0.  JAX runs its ppermute ring for the fused
configurations.  EF caches equal across the ring (deviation 0); skipped
steps the same on every rank.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compactfusion_tpu.cache.accel import CacheAccelConfig as JCache
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models.flux import flux_tiny, init_flux
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.flux import FluxPipeline as JFlux
from compactfusion_tpu.pipelines.flux import FluxPipelineConfig as JFluxConfig
from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPixArt
from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPixArtConfig
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err, spice_params
from tests.test_torch_pipeline_ring import _inputs as pixart_inputs
from tests.test_torch_rank_fns import sp_pipeline_latents

STEPS = 4
BOUND = 2e-4
U2R2 = dict(ulysses_degree=2, ring_degree=2)
BINARY = dict(enabled=True, compress_type="binary", warmup_steps=1, check_consistency=True)
PATCH = dict(enabled=True, warmup_steps=1, residual=1, patch_gather=True)
# (name, ParallelConfig kwargs, CompactConfig kwargs, CacheAccelConfig kwargs, batch, lossless twin)
PIXART = [
    ("u2r2-lossless", U2R2, None, None, 1, None),
    ("u2r2-lossless-fused", dict(U2R2, use_fused_ring=True), None, None, 1, None),
    ("u2r2-binary", U2R2, BINARY, None, 1, "u2r2-lossless"),
    ("u2r2-binary-fused", dict(U2R2, use_fused_ring=True), BINARY, None, 1, "u2r2-lossless"),
    ("u2cfg2-lossless", dict(ulysses_degree=2, cfg_degree=2), None, None, 1, None),
    ("u4-lossless", dict(ulysses_degree=4), None, None, 1, None),
    ("r4-patch-sync", dict(ring_degree=4), dict(PATCH, compress_type="identity"), None, 1, None),
    ("r4-patch-binary", dict(ring_degree=4),
     dict(PATCH, compress_type="binary", error_feedback=True, check_consistency=True), None, 1,
     "r4-patch-sync"),
    ("r4-patch-async", dict(ring_degree=4),
     dict(PATCH, compress_type="identity", error_feedback=False, patch_async=True), None, 1, "r4-patch-sync"),
    ("dp2r2-fbcache-0", dict(dp_degree=2, ring_degree=2), None, dict(mode="fbcache", threshold=0.0), 2, None),
    ("dp2r2-fbcache-1e6", dict(dp_degree=2, ring_degree=2), None, dict(mode="fbcache", threshold=1e6), 2, None),
]
FLUX = [
    ("u2r2-lossless", U2R2, None, None, 1, None),
    ("u2r2-binary", U2R2, dict(BINARY, residual=1, error_feedback=True), None, 1, "u2r2-lossless"),
    ("u2r2-patch-gather", U2R2, dict(BINARY, residual=1, error_feedback=True, patch_gather=True), None, 1,
     "u2r2-lossless"),
]
SKIPS = {"dp2r2-fbcache-0": 0, "dp2r2-fbcache-1e6": STEPS - 2}


def _flux_inputs():
    from tests.test_torch_flux_pipeline import _inputs

    return _inputs()


@pytest.fixture(scope="module")
def models():
    pm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    fm = dataclasses.replace(flux_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    return {"pixart": (pm, jv, spice_params(init_pixart(jax.random.PRNGKey(0), pm))),
            "flux": (fm, jv, spice_params(init_flux(jax.random.PRNGKey(0), fm))),
            "vae": init_vae_decoder(jax.random.PRNGKey(1), jv)}


@pytest.fixture(scope="module")
def spawned(models):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vae = to_np(models["vae"])
    jobs = {"pixart": ([c[:5] for c in PIXART], to_np(models["pixart"][2]), vae,
                       {b: pixart_inputs(b) for b in (1, 2)}),
            "flux": ([c[:5] for c in FLUX], to_np(models["flux"][2]), vae, _flux_inputs())}
    return tmesh.spawn_local(sp_pipeline_latents, 4, "gloo", jobs, threads=1, timeout=600)


def _jax_compact(ckw):
    if ckw is None:
        return JCompact()
    return JCompact(**dict(ckw, compress_type=JType(ckw["compress_type"])))


@pytest.fixture(scope="module")
def jax_latents(models):
    @functools.lru_cache(maxsize=None)
    def run(family, name):
        _, par, ckw, cache, batch, _ = {c[0]: c for c in (PIXART if family == "pixart" else FLUX)}[name]
        m, jv, params = models[family]
        kw = dict(model=m, vae=jv, parallel=JParallel(**par), num_steps=STEPS, compact=_jax_compact(ckw),
                  cache=JCache(**(cache or {})))
        if family == "pixart":
            jc = JPixArtConfig(height=64, width=64, **kw)
            inputs, pipe_cls = pixart_inputs(batch), JPixArt
        else:
            jc = JFluxConfig(height=64, width=128, **kw)
            inputs, pipe_cls = _flux_inputs(), JFlux
        pipe = pipe_cls(params, models["vae"], jc, make_mesh(jc.parallel, devices=jax.devices()[:4]))
        return np.asarray(pipe._sample(params, *map(jnp.asarray, inputs)))

    return run


def _check(spawned, jax_latents, family, config):
    name, _, compact, cache, batch, twin = config
    ref = jax_latents(family, name)
    for rank, res in enumerate(spawned):
        lat, dev, skips = res[family, name]
        assert lat.shape == ref.shape
        if twin is None:
            assert rel_err(lat, ref) < BOUND, rank
        else:
            jax_err = rel_err(ref, jax_latents(family, twin))
            assert jax_err > 0 and rel_err(lat, res[family, twin][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_err, rank
        if compact is not None and compact.get("check_consistency"):
            assert dev == 0.0, rank
        assert skips == SKIPS.get(name), rank
        # every rank holds the same latents
        np.testing.assert_array_equal(lat, spawned[0][family, name][0])


@pytest.mark.parametrize("config", PIXART, ids=lambda c: c[0])
def test_pixart_sp_matches_jax(spawned, jax_latents, config):
    _check(spawned, jax_latents, "pixart", config)


@pytest.mark.parametrize("config", FLUX, ids=lambda c: c[0])
def test_flux_sp_matches_jax(spawned, jax_latents, config):
    _check(spawned, jax_latents, "flux", config)


def test_flux_patch_gather_is_the_compressed_usp(spawned):
    """FLUX routes ``patch_gather`` to the compressed USP, as the JAX
    package does: the same latents as the BINARY USP run, bit for bit."""
    for res in spawned:
        np.testing.assert_array_equal(res["flux", "u2r2-patch-gather"][0], res["flux", "u2r2-binary"][0])
