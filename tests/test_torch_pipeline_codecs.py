"""The ported compression layer on the whole slice vs the JAX pipeline:
pixart_tiny + tiny_vae in fp32, 4 DPM-Solver++ steps with CFG, the ring-2
``simulate_ring`` emulation, the same noise fed to JAX ``pipe._sample`` and
to the port, for INT2, LOW_RANK rank 2 (the JAX start basis handed to the
port, see test_torch_lowrank.py), and a per-layer ``compress_func`` plan
(layer 0 INT2, layer 1 BINARY with a rank-2 scale) on int8-quantized EF
caches.

Bound, as in test_torch_pipeline.py: the port reproduces the JAX run's
compression error, so its distance from the JAX latents stays below a tenth
of the JAX run's distance from its lossless latents (a code at a threshold
may still flip between the frameworks' fp32 summation orders); both codec
errors must be > 0.
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
from compactfusion_tpu_torch.compact import lowrank as tlowrank
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines import base as tbase
from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_lowrank import jax_init_q

STEPS = 4


def _plan(types):
    """WARMUP at step 0, then layer 0 INT2 and layer 1 BINARY."""
    return lambda layer, step: types.WARMUP if step < 1 else (types.INT2 if layer == 0 else types.BINARY)


CONFIGS = {
    "lossless": {},
    "int2": dict(compress_type="int2"),
    "low-rank": dict(compress_type="low-rank", comp_rank=2),
    "plan": dict(compress_type="binary", comp_rank=2, quantized_cache=True, plan=True),
}


def _compact(name, cfg_cls, types):
    kw = dict(CONFIGS[name])
    if not kw:
        return cfg_cls()
    plan = kw.pop("plan", False)
    kw["compress_type"] = types(kw["compress_type"])
    return cfg_cls(enabled=True, warmup_steps=1, simulate_ring=2,
                   compress_func=_plan(types) if plan else None, **kw)


@pytest.fixture(scope="module")
def run():
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
    mask[1, 0, 4:] = False
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)
    mesh = make_mesh(JParallel(), devices=jax.devices()[:1])
    cache = {}

    def go(name):
        if name in cache:
            return cache[name]
        jc = JPipelineConfig(model=jm, vae=jv, compact=_compact(name, JCompact, JType),
                             num_steps=STEPS, height=64, width=64)
        jpipe = JPipeline(jparams, jvae, jc, mesh)
        jlat = np.asarray(jpipe._sample(jparams, jnp.asarray(text), jnp.asarray(mask),
                                        jnp.asarray(latents0)))
        jimg = np.asarray(jpipe._decode(jvae, jnp.asarray(jlat)))
        tc = PixArtPipelineConfig(model=tm, vae=tv, compact=_compact(name, CompactConfig, CompressType),
                                  num_steps=STEPS, height=64, width=64)
        tpipe = PixArtPipeline(tparams, tvae_params, tc, "cpu")
        patch = pytest.MonkeyPatch()
        patch.setattr(tlowrank, "_init_q", jax_init_q)
        try:
            tlat = tpipe(torch.from_numpy(text), torch.from_numpy(mask),
                         latents=torch.from_numpy(latents0), decode=False)
        finally:
            patch.undo()
        cache[name] = (jlat, jimg, tlat.numpy(), tpipe.decode(tlat).numpy())
        return cache[name]

    return go


@pytest.mark.parametrize("name", ["int2", "low-rank", "plan"])
def test_codec_emulation_matches_jax(run, name):
    jlat0, jimg0, tlat0, _ = run("lossless")
    jlat, jimg, tlat, timg = run(name)
    jax_codec_err = rel_err(jlat, jlat0)
    assert jax_codec_err > 0 and rel_err(tlat, tlat0) > 0
    assert rel_err(tlat, jlat) < 0.1 * jax_codec_err
    assert rel_err(timg, jimg) < 0.1 * rel_err(jimg, jimg0)
    assert np.isfinite(timg).all() and timg.min() >= 0.0 and timg.max() <= 1.0


def test_layer_plan_schedule():
    """Per-layer plans resolve to one layer segmentation for every step, as
    the JAX package's ``layer_plan_segments`` does, and group equal steps."""
    from compactfusion_tpu.pipelines import base as jbase

    B, I2, W = CompressType.BINARY, CompressType.INT2, CompressType.WARMUP
    plans = [(W,) * 4, (B, B, I2, I2), (B, I2, I2, I2)]
    jplans = [tuple(JType(m.value) for m in p) for p in plans]
    assert tbase.layer_plan_segments(plans, 4) == jbase.layer_plan_segments(jplans, 4) == (
        (0, 1), (1, 2), (2, 4))
    compact = CompactConfig(enabled=True, compress_func=_plan(CompressType))
    segs = tbase.compact_layer_segments(compact, 3, 2)
    jsegs = jbase.compact_layer_segments(JCompact(enabled=True, compress_func=_plan(JType)), 3, 2)
    assert [(tuple((m.value, n) for m, n in p), s) for p, s in segs] == [
        (tuple((m.value, n) for m, n in p), s) for p, s in jsegs]
    assert segs == [(((W, 1), (W, 1)), [0]), (((I2, 1), (B, 1)), [1, 2])]
