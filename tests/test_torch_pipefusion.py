"""Sync PipeFusion across gloo processes vs the JAX pipelines on the
8-device CPU mesh (fp32 tiny configs, 4 steps, the same inputs and noise).

One spawn of 8 gloo processes runs every configuration (a rank a
configuration leaves out only joins its groups): PixArt pp2, pp2 x ring 2
and pp2 x Ulysses 2 x ring 2 (``tests/models/test_pixart.py``'s
``test_pipefusion_matches_single_device``) lossless, and pp2 x ring 2
BINARY (residual 1 + EF, warmup 1, the consistency check on: each stage's
ring group holds its own layers' EF caches); FLUX pp2 on 3 + 3 blocks,
which pads each family with a zero-init identity block
(``pad_flux_for_pp``); CogVideoX pp2; and each family in one process.

Bounds: lossless latents within 2e-4 relative of JAX's pipeline at the same
parallel configuration and of the port's one-process run; sync PipeFusion
without a ring equal to one process bit for bit (the hops and the final
broadcast are exact copies, so every stage runs the kernels of one process
on its shapes); the compressed run within a tenth of JAX's own distance
from its lossless latents, EF deviation 0; every rank the same latents.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models import cogvideox as jcog
from compactfusion_tpu.models.flux import flux_tiny, init_flux
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.cogvideox import CogVideoXPipeline as JCog
from compactfusion_tpu.pipelines.cogvideox import CogVideoXPipelineConfig as JCogConfig
from compactfusion_tpu.pipelines.flux import FluxPipeline as JFlux
from compactfusion_tpu.pipelines.flux import FluxPipelineConfig as JFluxConfig
from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPixArt
from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPixArtConfig
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err, spice_params
from tests.test_torch_rank_fns import parallel_pipeline_latents

BOUND = 2e-4
BINARY = dict(enabled=True, compress_type="binary", warmup_steps=1, residual=1, error_feedback=True,
              check_consistency=True)
# family: [(name, ParallelConfig kwargs, CompactConfig kwargs, pipeline kwargs, lossless twin)]
CONFIGS = {
    "pixart": [("one", {}, None, {}, None),
               ("pp2", dict(pp_degree=2), None, {}, None),
               ("pp2-r2", dict(pp_degree=2, ring_degree=2), None, {}, None),
               ("pp2-u2r2", dict(pp_degree=2, ulysses_degree=2, ring_degree=2), None, {}, None),
               ("pp2-r2-binary", dict(pp_degree=2, ring_degree=2), BINARY, {}, "pp2-r2")],
    "flux": [("one", {}, None, {}, None), ("pp2", dict(pp_degree=2), None, {}, None)],
    "cogvideox": [("one", {}, None, {}, None), ("pp2", dict(pp_degree=2), None, {}, None)],
}
#: model overrides: FLUX at 3 + 3 blocks, so that pp 2 pads each family
MODEL_KW = {"pixart": {}, "flux": dict(double_layers=3, single_layers=3), "cogvideox": dict(use_rotary=True)}


def inputs(family):
    """The fp32 numpy inputs of a tiny family, noise last."""
    rng = np.random.default_rng(3)
    if family == "pixart":
        text = rng.standard_normal((2, 1, 6, 32)).astype(np.float32)
        mask = np.ones((2, 1, 6), bool)
        mask[1, 0, 4:] = False  # a padded uncond prompt
        return text, mask, rng.standard_normal((1, 16, 16)).astype(np.float32)
    if family == "flux":
        return (rng.standard_normal((1, 8, 32)).astype(np.float32), rng.standard_normal((1, 16)).astype(np.float32),
                rng.standard_normal((1, 32, 16)).astype(np.float32))
    return rng.standard_normal((2, 1, 6, 32)).astype(np.float32), rng.standard_normal((1, 18, 64)).astype(np.float32)


def jax_models(model_kw):
    """{family: (JAX model config, spiced fp32 params)} and the tiny VAE
    (config, params)."""
    out = {}
    for family, (cfg, init) in {"pixart": (pixart_tiny(), init_pixart), "flux": (flux_tiny(), init_flux),
                                "cogvideox": (jcog.cogvideox_tiny(), jcog.init_cogvideox)}.items():
        if family in model_kw:
            jm = dataclasses.replace(cfg, dtype=jnp.float32, **model_kw[family])
            out[family] = (jm, spice_params(init(jax.random.PRNGKey(0), jm)))
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    return out, (jv, init_vae_decoder(jax.random.PRNGKey(1), jv))


def jax_sample(models, family, par, compact=None, steps=4, **extra):
    """JAX ``pipe._sample`` of a tiny family on the first world-size CPU
    devices."""
    forms, (jv, jvae) = models
    jm, jp = forms[family]
    ckw = JCompact(**dict(compact, compress_type=JType(compact["compress_type"]))) if compact else JCompact()
    kw = dict(model=jm, parallel=JParallel(**par), num_steps=steps, compact=ckw, **extra)
    mesh = lambda jc: make_mesh(jc.parallel, devices=jax.devices()[:jc.parallel.world_size])  # noqa: E731
    args = [jnp.asarray(a) for a in inputs(family)]
    if family == "pixart":
        jc = JPixArtConfig(vae=jv, height=64, width=64, **kw)
        pipe = JPixArt(jp, jvae, jc, mesh(jc))
    elif family == "flux":
        jc = JFluxConfig(vae=jv, height=64, width=128, **kw)
        pipe = JFlux(jp, jvae, jc, mesh(jc))
    else:
        jc = JCogConfig(height=32, width=48, num_frames=9, **kw)
        pipe = JCog(jp, jc, mesh(jc))
    # FLUX pads its params under pp: sample with the pipeline's own tree
    return np.asarray(pipe._sample(pipe.params, *args))


def spawn_beside(fn, world, args, warm):
    """``spawn_local(fn, world, "gloo", *args)`` in a thread while ``warm()``
    (the JAX references) runs here: the two overlap."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tmesh.spawn_local, fn, world, "gloo", *args, threads=1, timeout=600)
        warm()
        return ranks.result()


def job(models, family, configs, model_kw):
    """The rank function's job of one family (its model overrides, the
    configurations' first four fields, numpy weights and inputs)."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    forms, (_, jvae) = models
    return (model_kw[family], [c[:4] for c in configs], to_np(forms[family][1]),
            to_np(jvae) if family != "cogvideox" else None, inputs(family))


@pytest.fixture(scope="module")
def models():
    return jax_models(MODEL_KW)


@pytest.fixture(scope="module")
def jax_latents(models):
    @functools.lru_cache(maxsize=None)
    def run(family, name):
        _, par, compact, extra, _ = {c[0]: c for c in CONFIGS[family]}[name]
        return jax_sample(models, family, par, compact, **extra)

    return run


@pytest.fixture(scope="module")
def spawned(models, jax_latents):
    jobs = {family: job(models, family, configs, MODEL_KW) for family, configs in CONFIGS.items()}
    return spawn_beside(parallel_pipeline_latents, 8, (jobs,),
                        lambda: [jax_latents(f, c[0]) for f, configs in CONFIGS.items() for c in configs])


def ranks_of(spawned, family, name):
    """The results of the ranks that ran the configuration."""
    return [r[family, name] for r in spawned if r[family, name] is not None]


CASES = [(f, c) for f, configs in CONFIGS.items() for c in configs if c[0] != "one"]


@pytest.mark.parametrize("family,config", CASES, ids=lambda x: x if isinstance(x, str) else x[0])
def test_sync_pipefusion_matches_jax(spawned, jax_latents, family, config):
    name, par, compact, _, twin = config
    ref = jax_latents(family, name)
    got = ranks_of(spawned, family, name)
    assert len(got) == JParallel(**par).world_size
    one = spawned[0][family, "one"][0]
    for rank, (lat, dev) in enumerate(got):
        assert lat.shape == ref.shape
        if twin is None:
            assert rel_err(lat, ref) < BOUND, rank
            assert rel_err(lat, one) < BOUND, rank
        else:
            jax_err = rel_err(ref, jax_latents(family, twin))
            assert jax_err > 0 and rel_err(lat, ranks_of(spawned, family, twin)[0][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_err, rank
            assert dev == 0.0, rank  # each stage's ring group holds equal EF caches
        np.testing.assert_array_equal(lat, got[0][0])


@pytest.mark.parametrize("family", list(CONFIGS))
def test_sync_pipefusion_equals_one_process(spawned, jax_latents, family):
    """Without a ring, sync PipeFusion runs one process's kernels on one
    process's shapes: the latents are its latents, bit for bit (FLUX's
    padded identity blocks included); the one-process run is JAX's."""
    one = spawned[0][family, "one"][0]
    assert rel_err(one, jax_latents(family, "one")) < BOUND
    for lat, _ in ranks_of(spawned, family, "pp2"):
        np.testing.assert_array_equal(lat, one)
