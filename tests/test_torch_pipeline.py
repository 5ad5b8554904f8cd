"""The whole ported slice vs the JAX pipeline: pixart_tiny + tiny_vae, fp32,
4 DPM-Solver++ steps with CFG, the same noise ``latents0`` fed to JAX
``pipe._sample`` and to the port.

* Compression off: latents and images within 2e-4 relative (the fp32
  backbone bound of tests/io/test_backbone_parity.py).
* Compressed-ring emulation (ring 2, binary, warmup 1, spiced params): the
  port must reproduce the compression error of the JAX run, so its distance
  from the JAX latents is bounded by a tenth of the JAX run's distance from
  its lossless latents.  Looser than 2e-4 by design: a sign at |delta| ~ 0
  may flip between the frameworks' fp32 summation orders and move one
  payload bit.  The error against the lossless run must also be > 0.
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
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPipeline
from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
from tests.helpers import rel_err, spice_params

STEPS = 4
BOUND = 2e-4


@pytest.fixture(scope="module")
def setup():
    jm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_pixart(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tvae_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jvae))
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 1, 6, jm.text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, 0, 4:] = False  # padded uncond prompt
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)
    mesh = make_mesh(JParallel(), devices=jax.devices()[:1])
    cache = {}

    def run(compressed):
        if compressed in cache:
            return cache[compressed]
        kw = dict(enabled=True, warmup_steps=1, simulate_ring=2) if compressed else {}
        jc = JPipelineConfig(model=jm, vae=jv, compact=JCompact(
            compress_type=JType.BINARY, **kw), num_steps=STEPS, height=64, width=64)
        jpipe = JPipeline(jparams, jvae, jc, mesh)
        jlat = np.asarray(jpipe._sample(jparams, jnp.asarray(text), jnp.asarray(mask),
                                        jnp.asarray(latents0)))
        jimg = np.asarray(jpipe._decode(jvae, jnp.asarray(jlat)))
        tc = PixArtPipelineConfig(model=tm, vae=tv, compact=CompactConfig(
            compress_type=CompressType.BINARY, **kw), num_steps=STEPS, height=64, width=64)
        tpipe = PixArtPipeline(tparams, tvae_params, tc, "cpu")
        tlat = tpipe(torch.from_numpy(text), torch.from_numpy(mask),
                     latents=torch.from_numpy(latents0), decode=False)
        timg = tpipe.decode(tlat)
        cache[compressed] = (jlat, jimg, tlat.numpy(), timg.numpy())
        return cache[compressed]

    return run


def test_lossless_slice_matches_jax(setup):
    jlat, jimg, tlat, timg = setup(False)
    assert tlat.shape == (1, 16, 16) and timg.shape == (1, 16, 16, 3)
    assert rel_err(tlat, jlat) < BOUND
    assert rel_err(timg, jimg) < BOUND
    assert timg.min() >= 0.0 and timg.max() <= 1.0


def test_compressed_ring_emulation_matches_jax(setup):
    jlat0, _, tlat0, _ = setup(False)
    jlat, jimg, tlat, timg = setup(True)
    jax_codec_err = rel_err(jlat, jlat0)
    port_codec_err = rel_err(tlat, tlat0)
    assert jax_codec_err > 0 and port_codec_err > 0
    assert rel_err(tlat, jlat) < 0.1 * jax_codec_err
    assert rel_err(timg, jimg) < 0.1 * rel_err(jimg, setup(False)[1])


def test_generator_noise_and_unported_configs():
    tm, tv = tpix.pixart_tiny(), tvae.tiny_vae()
    params = tpix.init_pixart(torch.Generator().manual_seed(0), tm)
    vparams = tvae.init_vae_decoder(torch.Generator().manual_seed(1), tv)
    cfg = PixArtPipelineConfig(model=tm, vae=tv, num_steps=2, height=64, width=64)
    pipe = PixArtPipeline(params, vparams, cfg, "cpu")
    text = torch.randn(2, 1, 5, tm.text_dim)
    a = pipe(text, None, generator=torch.Generator().manual_seed(3))
    b = pipe(text, None, generator=torch.Generator().manual_seed(3))
    assert a.shape == (1, 16, 16, 3) and torch.equal(a, b)
    assert bool(torch.isfinite(a.float()).all())
    with pytest.raises(ValueError):
        pipe(text, None)
    # PipeFusion is ported: its stages need this rank's mesh
    staged = PixArtPipelineConfig(model=tm, vae=tv, parallel=ParallelConfig(pp_degree=2),
                                  height=64, width=64)
    with pytest.raises(ValueError, match="mesh"):
        PixArtPipeline(params, vparams, staged, "cpu")
    across = PixArtPipelineConfig(model=tm, vae=tv, parallel=ParallelConfig(ring_degree=2),
                                  height=64, width=64)
    with pytest.raises(ValueError, match="mesh"):  # a ring across ranks needs this rank's mesh
        PixArtPipeline(params, vparams, across, "cpu")
    # the compressed ring on one rank compresses its own K/V and attends them
    # exact: the lossless image
    ring = PixArtPipelineConfig(model=tm, vae=tv, num_steps=2, height=64, width=64,
                                compact=CompactConfig(enabled=True, warmup_steps=1))
    c = PixArtPipeline(params, vparams, ring, "cpu")(text, None, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c, a)
