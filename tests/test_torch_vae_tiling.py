"""The 2D VAE's decode memory knobs vs the JAX package
(``tests/core/test_vae_tiling.py``'s five cases, on the same fp32
``tiny_vae`` weights): slicing is bit-equal to the dense decode, tiling
passes a small latent through to the dense decode bit for bit, the tiled
decode has the full frame's shape, a seam error against the dense decode
in (0, 0.5) (the JAX test's bound) and lies within 2e-4 relative of JAX's
tiled decode, tiling and slicing compose as per-element tiled decodes, and
``--enable_tiling`` / ``--enable_slicing`` reach the pipeline's VAE config
through the port's ``_vae_opts``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import vae as tvae
from tests.helpers import rel_err

BOUND = 2e-4


@pytest.fixture(scope="module")
def vae():
    jcfg = dataclasses.replace(jvae.tiny_vae(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    jp = jvae.init_vae_decoder(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _latents(b, h, w, seed=0):
    return np.random.default_rng(seed).standard_normal((b, h, w, 4)).astype(np.float32)


def test_slicing_is_exact(vae):
    _, tcfg, _, tp = vae
    lat = torch.from_numpy(_latents(3, 12, 12))
    dense = tvae.vae_decode(tp, lat, tcfg)
    sliced = tvae.vae_decode(tp, lat, dataclasses.replace(tcfg, use_slicing=True))
    assert torch.equal(dense, sliced)


def test_tiling_passthrough_when_small(vae):
    _, tcfg, _, tp = vae
    lat = torch.from_numpy(_latents(1, 12, 12))
    dense = tvae.vae_decode(tp, lat, tcfg)
    tiled = tvae.vae_decode(tp, lat, dataclasses.replace(tcfg, use_tiling=True, tile_latent_size=32))
    assert torch.equal(dense, tiled)


@pytest.mark.parametrize("h,w", [(20, 20), (24, 16)])
def test_tiled_decode_shape_and_seam_error(vae, h, w):
    jcfg, tcfg, jp, tp = vae
    kw = dict(use_tiling=True, tile_latent_size=8, tile_overlap_factor=0.25)
    lat = _latents(1, h, w, seed=h * 31 + w)
    dense = tvae.vae_decode(tp, torch.from_numpy(lat), tcfg)
    tiled = tvae.vae_decode_tiled(tp, torch.from_numpy(lat), dataclasses.replace(tcfg, **kw))
    f = tcfg.upscale_factor
    assert tiled.shape == (1, h * f, w * f, tcfg.out_channels)
    assert torch.isfinite(tiled).all()
    assert 0.0 < rel_err(tiled.numpy(), dense.numpy()) < 0.5
    # jitted: one XLA program for every tile (eager JAX compiles op by op, per tile shape)
    want = jax.jit(jvae.vae_decode_tiled, static_argnums=2)(jp, jnp.asarray(lat), dataclasses.replace(jcfg, **kw))
    assert rel_err(tiled.numpy(), want) < BOUND


def test_tiled_plus_sliced_compose(vae):
    _, tcfg, _, tp = vae
    cfg = dataclasses.replace(tcfg, use_tiling=True, use_slicing=True, tile_latent_size=8)
    lat = torch.from_numpy(_latents(2, 20, 20))
    out = tvae.vae_decode(tp, lat, cfg)
    per = torch.cat([tvae.vae_decode_tiled(tp, lat[i:i + 1], dataclasses.replace(cfg, use_slicing=False))
                     for i in range(2)], dim=0)
    assert torch.equal(out, per)


def test_cli_flags_reach_vae_config():
    from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
    from compactfusion_tpu_torch.parallel_api import _vae_opts

    parser = xFuserArgs.add_cli_args(FlexibleArgumentParser())
    engine, _ = xFuserArgs.from_cli_args(
        parser.parse_args(["--model", "tiny-pixart", "--enable_tiling", "--enable_slicing"])).create_config()
    assert engine.runtime_config.enable_tiling and engine.runtime_config.enable_slicing
    vcfg = _vae_opts(tvae.tiny_vae(), engine)
    assert vcfg.use_tiling and vcfg.use_slicing
    # the tile geometry is the JAX package's
    j, t = jvae.VAEConfig(), tvae.VAEConfig()
    assert (t.tile_latent_size, t.tile_overlap_factor) == (j.tile_latent_size, j.tile_overlap_factor)
