"""Latte vs the JAX package on the CPU, fp32, ``latte_tiny`` (2 pairs, dim
64) with spiced modulation tables, bound 2e-4 (the fp32 bound of
tests/io/test_backbone_parity.py).

* ``init_latte``'s tree; ``latte_forward`` with a padded text mask.
* The tiny pipeline (32 x 32, 4 frames of 2 x 2 patches, 3 DDIM steps at
  guidance 4.5, the per-frame tiny VAE) against JAX ``pipe._sample`` and
  ``pipe._decode``.
* One spawn of 4 gloo processes: ring 2, Ulysses 2 and cfg 2 (the
  frame-aligned all-to-alls of each temporal block, 2 ranks; the other 2
  idle) and Ulysses 2 x ring 2 (the two-step all-to-all), against JAX's
  run on a CPU mesh of the same layout; the bytes the all-to-alls send.
  In the same spawn tp 2 and tp 2 x cfg 2 (the ffns split over tp) against
  JAX's one-device run, and pp 2 (whole weights on each rank) against JAX's
  pp-2 run and bit for bit against the port's one process.  JAX's own tp-2
  run is not the reference: it sums whole ffns over tp (a recorded
  divergence, held here).
* The geometry error with JAX's message; ``xDiTParallel`` on
  ``latte-tiny`` from a prompt against the JAX runner; the example.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import latte as jlatte
from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.latte import LattePipeline as JPipe
from compactfusion_tpu.pipelines.latte import LattePipelineConfig as JCfg
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.examples import latte_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import latte as tlatte
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_api import _np
from tests.test_torch_rank_fns import latte_latents

BOUND = 2e-4
SIZE = dict(height=32, width=32, num_frames=4)
LAYOUTS = [("ring2", dict(ring_degree=2)), ("u2", dict(ulysses_degree=2)), ("cfg2", dict(cfg_degree=2)),
           ("u2r2", dict(ulysses_degree=2, ring_degree=2)), ("tp2", dict(tp_degree=2)), ("pp2", dict(pp_degree=2)),
           ("tp2cfg2", dict(tp_degree=2, cfg_degree=2))]
#: the ffn's hidden width of ``latte_tiny`` (dim 64 x 4)
HIDDEN = 256


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(jlatte.latte_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(jvae.tiny_vae(), dtype=jnp.float32)
    return jm, spice_params(jlatte.init_latte(jax.random.PRNGKey(0), jm)), jv, jvae.init_vae_decoder(
        jax.random.PRNGKey(1), jv)


def _inputs(tokens=16, seed=3):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((2, 1, 6, 32)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, 0, 4:] = False
    return text, mask, rng.standard_normal((1, tokens, 16)).astype(np.float32)


def test_init_tree_and_forward_match_jax(models):
    jm, jp, _, _ = models
    tm = dataclasses.replace(tlatte.latte_tiny(), dtype=torch.float32)
    own = tlatte.init_latte(torch.Generator().manual_seed(0), tm)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    rng = np.random.default_rng(5)
    b, f, hp, wp = 2, 4, 2, 2
    x = rng.standard_normal((b, f * hp * wp, 16)).astype(np.float32)
    text = rng.standard_normal((b, 6, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    t = np.array([10.0, 700.0], np.float32)
    pos = jcm.sincos_pos_embed_2d(jm.dim, hp, wp)
    tpos = jcm._sincos_embed_1d(jnp.arange(f, dtype=jnp.float32), jm.dim)
    want, _ = jlatte.latte_forward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), jm, frames_local=f,
                                   frames_total=f, spatial_tokens=hp * wp, pos_embed=pos, temporal_pos_embed=tpos,
                                   text_mask=jnp.asarray(mask))
    got, _ = tlatte.latte_forward(params_from_numpy(_np(jp)), torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(text), tm, frames_local=f, frames_total=f, spatial_tokens=hp * wp,
                                  pos_embed=tcm.sincos_pos_embed_2d(tm.dim, hp, wp),
                                  temporal_pos_embed=tcm._sincos_embed_1d(torch.arange(f, dtype=torch.float32),
                                                                          tm.dim),
                                  text_mask=torch.from_numpy(mask))
    assert got.shape == (b, f * hp * wp, 32)
    assert rel_err(got.numpy(), np.asarray(want)) < BOUND


@pytest.fixture(scope="module")
def jax_run(models):
    jm, jp, jv, jvp = models
    cache = {}

    def run(par=()):
        par = dict(par)
        key = tuple(sorted(par.items()))
        if key not in cache:
            jc = JCfg(model=jm, parallel=JParallel(**par), num_steps=3, guidance_scale=4.5, **SIZE)
            n = jc.parallel.world_size
            pipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:n]), vae_params=jvp, vae_cfg=jv)
            text, mask, noise = _inputs()
            lat = np.asarray(pipe._sample(jp, jnp.asarray(text), jnp.asarray(mask), jnp.asarray(noise)))
            cache[key] = (lat, np.asarray(pipe._decode(jvp, jnp.asarray(lat))))
        return cache[key]

    return run


def test_tiny_pipeline_matches_jax(models, jax_run):
    jm, jp, jv, jvp = models
    jlat, jvid = jax_run()
    tm = dataclasses.replace(tlatte.latte_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    cfg = LattePipelineConfig(model=tm, vae=tv, num_steps=3, guidance_scale=4.5, **SIZE)
    pipe = LattePipeline(params_from_numpy(_np(jp)), params_from_numpy(_np(jvp)), cfg, "cpu")
    text, mask, noise = (torch.from_numpy(a) for a in _inputs())
    lat = pipe(text, mask, latents=noise, decode=False)
    vid = pipe.decode(lat)
    assert lat.shape == jlat.shape == (1, 16, 16) and vid.shape == jvid.shape == (1, 4, 8, 8, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND and rel_err(vid.numpy(), jvid) < BOUND
    assert 0.0 <= vid.min() and vid.max() <= 1.0
    a = pipe(text, None, generator=torch.Generator().manual_seed(2))
    assert a.shape == (1, 4, 8, 8, 3) and torch.equal(a, pipe(text, None, generator=torch.Generator().manual_seed(2)))


@pytest.fixture(scope="module")
def spawned(models):
    _, jp, _, _ = models
    return tmesh.spawn_local(latte_latents, 4, "gloo", LAYOUTS, _np(jp), None, _inputs(), threads=1, timeout=300)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: c[0])
def test_latte_across_ranks_matches_jax(spawned, jax_run, layout):
    name, par = layout
    tp = par.get("tp_degree", 1)
    # tp against the JAX one-device run: JAX's tp run sums whole ffns
    want = jax_run(tuple(par.items()))[0] if tp == 1 else jax_run()[0]
    one = jax_run()[0]
    world = JParallel(**par).world_size
    sp = JParallel(**par).sp_degree
    # each temporal block: two all-to-alls of the (B, f_l, s_sp, D) activations,
    # (sp - 1) / sp of them leaving the rank; CFG doubles the batch
    b = 1 if par.get("cfg_degree") == 2 else 2
    want_bytes = 0 if sp == 1 else 2 * 2 * 3 * (b * 4 // sp * 4 * 64 * 4) * (sp - 1) // sp
    for rank, res in enumerate(spawned):
        got = res[name]
        if rank >= world:
            assert got is None
            continue
        lat, sent, hidden = got
        assert rel_err(lat, want) < BOUND and rel_err(lat, one) < BOUND, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])
        if name != "u2r2":
            assert sent == want_bytes, (rank, sent, want_bytes)
        # a tp rank holds its share of every ffn, a pp rank every layer whole
        assert hidden == HIDDEN // tp, (rank, hidden)
        if name == "pp2":  # the whole model on the whole weights: one process's run
            np.testing.assert_array_equal(lat, res["one process"][0])


def test_jax_tp2_sums_whole_ffns(jax_run):
    """The recorded divergence: the JAX pipeline passes ``tp_axis`` to
    ``latte_forward`` but hands each tp rank the whole weights, so its ffn
    sum counts every ffn twice and its tp-2 run leaves its one-device run,
    where its pp-2 run stays on it bit for bit."""
    one = jax_run()[0]
    err = rel_err(jax_run((("tp_degree", 2),))[0], one)
    print(f"JAX Latte tp 2 vs its one-device run: {err:.3g}")  # the recorded figure (pytest -s)
    assert err > 1e-3
    np.testing.assert_array_equal(jax_run((("pp_degree", 2),))[0], one)


def test_geometry_error_matches_jax():
    for par in (dict(ring_degree=3), dict(ulysses_degree=2, ring_degree=4)):
        with pytest.raises(ValueError) as jerr:
            JCfg(model=jlatte.latte_tiny(), parallel=JParallel(**par), **SIZE)
        with pytest.raises(ValueError) as terr:
            LattePipelineConfig(model=tlatte.latte_tiny(), parallel=ParallelConfig(**par), **SIZE)
        assert str(terr.value) == str(jerr.value)
    # PipeFusion and tensor parallelism are Latte layouts in both packages
    for par in (dict(pp_degree=2), dict(tp_degree=2), dict(tp_degree=2, cfg_degree=2)):
        assert JCfg(model=jlatte.latte_tiny(), parallel=JParallel(**par), **SIZE).parallel.world_size > 1
        assert LattePipelineConfig(model=tlatte.latte_tiny(), parallel=ParallelConfig(**par),
                                   **SIZE).parallel.world_size > 1


def test_local_params_split_only_the_ffns(models):
    """At tp 2 the Latte tree's ffns alone split (no other subtree is an
    ``FFN_KEYS`` one), and at pp 2 no stack is cut (neither is a
    ``BLOCK_KEYS`` stack)."""
    from compactfusion_tpu_torch.parallel.tp import shard_params

    full = params_from_numpy(_np(models[1]))
    flat = dict(jax.tree_util.tree_flatten_with_path(full)[0])
    for kw in (dict(tp_index=1, tp_size=2), dict(pp_index=1, pp_size=2)):
        part = dict(jax.tree_util.tree_flatten_with_path(shard_params(full, **kw))[0])
        assert part.keys() == flat.keys()
        changed = sorted(jax.tree_util.keystr(k) for k in flat if part[k].shape != flat[k].shape)
        if "tp_size" in kw:
            assert changed == [f"['{stack}']['ffn']['{fc}']['{leaf}']" for stack in ("spatial_blocks",
                               "temporal_blocks") for fc, leaf in (("fc1", "b"), ("fc1", "w"), ("fc2", "w"))]
        else:
            assert changed == [] and all(part[k] is flat[k] for k in flat)


TINY = ["--model", "latte-tiny", "--height", "32", "--width", "32", "--num_frames", "4", "--num_inference_steps",
        "2", "--max_sequence_length", "8", "--prompt", "a cat", "--seed", "5"]


def jax_video_runner(argv):
    """The JAX runner of a video family from a command line, moved to fp32
    (backbone, VAE, T5), and its weights as numpy trees."""
    from compactfusion_tpu import args as jargs
    from compactfusion_tpu import parallel_api as japi
    from tests.test_torch_api import _config, _f32

    jr = japi.xDiTParallel(*_config(jargs, argv))
    pcfg, pipe = jr.pipeline_config, jr.pipeline
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, dtype=jnp.float32))
    vcfg = dataclasses.replace(pipe.vae_cfg, dtype=jnp.float32)
    params, vae = _f32(pipe.params), _f32(pipe.vae_params)
    jr.pipeline = type(pipe)(params, cfg, pipe.mesh, vae_params=vae, vae_cfg=vcfg)
    jr.pipeline.lfe_params = getattr(pipe, "lfe_params", None)
    jr.pipeline_config = cfg
    enc = jr.prompt_encoder
    enc.t5.params = _f32(enc.t5.params)
    enc.t5.cfg = dataclasses.replace(enc.t5.cfg, dtype=jnp.float32)
    enc._jit_t5, enc._jit_clip = None, {}
    return jr, {"params": _np(params), "vae": _np(vae), "t5": _np(enc.t5.params)}


def test_tiny_runner_matches_jax(tmp_path, monkeypatch):
    from tests.test_torch_rank_fns import port_runner

    jr, weights = jax_video_runner(TINY)
    tr = port_runner(TINY, weights)
    assert tr.family == jr.family == "latte"
    cfg, inp = jr.pipeline_config, jr.input_config
    noise = np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (1, cfg.tokens, 16), jnp.float32))
    jlat, jvid = np.asarray(jr(decode=False)), np.asarray(jr())
    lat, vid = tr(latents=torch.from_numpy(noise), decode=False), tr(latents=torch.from_numpy(noise))
    assert lat.shape == jlat.shape == (1, 16, 16) and vid.shape == jvid.shape == (1, 4, 8, 8, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND and rel_err(vid.numpy(), jvid) < BOUND
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(latte_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = latte_example.main(TINY)
    assert out.shape == (1, 4, 8, 8, 3) and saved == "results/latte_rank0.npy"
