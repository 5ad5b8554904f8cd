"""ConsisID vs the JAX package on the CPU, fp32, ``consisid_tiny`` (2
blocks, a perceiver after block 0) with spiced modulation biases and
perceiver weights, bound 2e-4 (the fp32 bound of tests/io/
test_backbone_parity.py).

* ``init_consisid``'s tree; ``consisid_forward`` with identity tokens and
  without (CogVideoX's forward); ``perceiver_ca``.
* The tiny pipeline (32 x 48, 9 frames: 18 video tokens, 3 steps at
  guidance 6, the tiny 3D VAE) with identity tokens and with the zero
  tokens of a request without an image, against JAX ``pipe._sample`` /
  ``pipe._decode``; ``encode_face`` against JAX's.
* One spawn of 2 gloo processes with identity tokens: ring 2 and U2
  lossless, ring 2 BINARY (residual 1 + EF, warmup 1, unfused: 9 local +
  6 text query rows) and sync pp2 (the perceiver injected at each stage's
  own block indices), against JAX on a CPU mesh of the same layout:
  lossless within 2e-4 of JAX's one-device run, pp2 bit-equal to the
  port's one process, BINARY within a tenth of JAX's own distance from its
  lossless latents; EF caches equal on the ring peers.
* ``xDiTParallel`` on ``consisid-tiny`` from a prompt, without and with
  ``--img_file_path`` (the stand-in identity tokens), against the JAX
  runner; the example.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from compactfusion_tpu.models import cogvideox as jcog
from compactfusion_tpu.models import consisid as jcon
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import face as jface
from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.consisid import ConsisIDPipeline as JPipe
from compactfusion_tpu.pipelines.consisid import ConsisIDPipelineConfig as JCfg
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.examples import consisid_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import consisid as tcon
from compactfusion_tpu_torch.models import face as tface
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.models.cogvideox import video_positions
from compactfusion_tpu_torch.pipelines.consisid import ConsisIDPipeline, ConsisIDPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_api import _np
from tests.test_torch_latte import jax_video_runner
from tests.test_torch_rank_fns import port_runner

BOUND = 2e-4
SIZE = dict(height=32, width=48, num_frames=9)


def _spiced(params, seed=7):
    """Modulation biases spiced, and the perceivers' weights drawn (a fresh
    init leaves them trunc-normal 0.02, too small to move the latents)."""
    p = spice_params(params)
    rng = np.random.default_rng(seed)
    p["perceiver"] = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.3, a.dtype),
                                            p["perceiver"])
    return p


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(jcon.consisid_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(jvae3d.tiny_vae3d(), latent_channels=16, dtype=jnp.float32)
    return jm, _spiced(jcon.init_consisid(jax.random.PRNGKey(0), jm)), jv, jvae3d.init_vae3d_decoder(
        jax.random.PRNGKey(1), jv)


def _tm():
    return dataclasses.replace(tcon.consisid_tiny(), dtype=torch.float32)


def test_init_tree_and_forward_match_jax(models):
    jm, jp, _, _ = models
    own = tcon.init_consisid(torch.Generator().manual_seed(0), _tm())
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    rng = np.random.default_rng(25)
    f, hp, wp = 2, 4, 4
    vid = rng.standard_normal((2, f * hp * wp, 64)).astype(np.float32)
    txt = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ids = rng.standard_normal((2, 5, 16)).astype(np.float32)
    t = np.array([230.0, 540.0], np.float32)
    tp = params_from_numpy(_np(jp))
    rope_j = jcm.rope_frequencies(jcog.video_positions(f, hp, wp), jm.axes_dim)
    rope_t = tcm.rope_frequencies(video_positions(f, hp, wp), jm.axes_dim)
    for id_states in (ids, None):
        want, _ = jcon.consisid_forward(jp, jnp.asarray(vid), jnp.asarray(txt),
                                        None if id_states is None else jnp.asarray(id_states), jnp.asarray(t), jm,
                                        video_rope=rope_j)
        got, _ = tcon.consisid_forward(tp, torch.from_numpy(vid), torch.from_numpy(txt),
                                       None if id_states is None else torch.from_numpy(id_states),
                                       torch.from_numpy(t), _tm(), video_rope=rope_t)
        assert rel_err(got.numpy(), np.asarray(want)) < BOUND
    # the identity moves the output
    assert rel_err(got.numpy(), np.asarray(jcon.consisid_forward(
        jp, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(ids), jnp.asarray(t), jm, video_rope=rope_j)[0])) > 1e-3
    lat = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["perceiver"])
    want = jcon.perceiver_ca(pj, jnp.asarray(ids), jnp.asarray(lat), 4)
    got = tcon.perceiver_ca(tcm.layer_of(tp["perceiver"], 0), torch.from_numpy(ids), torch.from_numpy(lat), 4)
    assert rel_err(got.numpy(), np.asarray(want)) < BOUND


@pytest.fixture(scope="module")
def jax_pipe(models):
    jm, jp, jv, jvp = models
    jc = JCfg(model=jm, num_steps=3, guidance_scale=6.0, **SIZE)
    return JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:1]), vae_params=jvp, vae_cfg=jv)


def test_tiny_pipeline_matches_jax(models, jax_pipe):
    jm, jp, jv, jvp = models
    tv = dataclasses.replace(tvae3d.tiny_vae3d(), latent_channels=16, dtype=torch.float32)
    cfg = ConsisIDPipelineConfig(model=_tm(), vae=tv, num_steps=3, guidance_scale=6.0, **SIZE)
    pipe = ConsisIDPipeline(params_from_numpy(_np(jp)), params_from_numpy(_np(jvp)), cfg, "cpu")
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((2, 1, 6, 32)).astype(np.float32)
    noise = rng.standard_normal((1, cfg.tokens, 64)).astype(np.float32)
    ids = rng.standard_normal((1, 5, 16)).astype(np.float32)
    lats = []
    for id_states in (ids, None):
        jids = jnp.zeros((1, 5, 16), jnp.float32) if id_states is None else jnp.asarray(id_states)
        jlat = np.asarray(jax_pipe._sample(jp, jnp.asarray(txt), jids, jnp.asarray(noise)))
        lat = pipe(torch.from_numpy(txt), latents=torch.from_numpy(noise), decode=False,
                   id_states=None if id_states is None else torch.from_numpy(id_states))
        assert lat.shape == jlat.shape == (1, 18, 64)
        assert rel_err(lat.numpy(), jlat) < BOUND
        lats.append(lat)
    assert rel_err(lats[0].numpy(), lats[1].numpy()) > 1e-3
    vid = pipe.decode(lats[0])
    jvid = np.asarray(jax_pipe._decode(jvp, jnp.asarray(lats[0].numpy())))
    assert vid.shape == jvid.shape == (1, 5, 8, 12, 3) and rel_err(vid.numpy(), jvid) < BOUND
    # the face encoder through the pipeline
    lc = jface.lfe_tiny()
    lp = jface.init_lfe(jax.random.PRNGKey(2), lc)
    id_cond = rng.standard_normal((1, lc.id_dim)).astype(np.float32)
    vits = [rng.standard_normal((1, 9, lc.vit_dim)).astype(np.float32) for _ in range(lc.num_scale)]
    want = np.asarray(jax_pipe.encode_face(lp, jnp.asarray(id_cond), [jnp.asarray(v) for v in vits], lc))
    got = pipe.encode_face(params_from_numpy(_np(lp)), torch.from_numpy(id_cond), [torch.from_numpy(v) for v in vits],
                           tface.lfe_tiny())
    assert rel_err(got.numpy(), want) < BOUND


BINARY = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True, check_consistency=True,
              compress_type="binary")
RING2 = dict(ring_degree=2)
CONFIGS = [("ring2", RING2, None), ("u2", dict(ulysses_degree=2), None), ("pp2", dict(pp_degree=2), None),
           ("ring2 binary", RING2, BINARY)]


def _inputs(seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 1, 6, 32)).astype(np.float32), rng.standard_normal((1, 5, 16)).astype(np.float32),
            rng.standard_normal((1, 18, 64)).astype(np.float32))


@pytest.fixture(scope="module")
def spawned(models):
    from compactfusion_tpu_torch.parallel import mesh as tmesh
    from tests.test_torch_rank_fns import video_pipeline_latents

    return tmesh.spawn_local(video_pipeline_latents, 2, "gloo", "consisid", CONFIGS, _np(models[1]), _inputs(),
                             threads=1, timeout=300)


@pytest.fixture(scope="module")
def jax_latents(models):
    """JAX's final latents at a layout, lossless or BINARY, cached."""
    from compactfusion_tpu.config import CompactConfig as JCompact
    from compactfusion_tpu.config import CompressType as JType
    from compactfusion_tpu.config import ParallelConfig as JParallel

    jm, jp, _, _ = models

    @functools.lru_cache(maxsize=None)
    def run(par_items=(), compact=False):
        jc = JCfg(model=jm, parallel=JParallel(**dict(par_items)), num_steps=3, guidance_scale=6.0,
                  compact=JCompact(**dict(BINARY, compress_type=JType.BINARY)) if compact else JCompact(), **SIZE)
        pipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:jc.parallel.world_size]))
        txt, ids, noise = _inputs()
        return np.asarray(pipe._sample(jp, jnp.asarray(txt), jnp.asarray(ids), jnp.asarray(noise)))

    return run


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_consisid_across_ranks_matches_jax(models, spawned, jax_latents, config):
    name, par, compact = config
    one = jax_latents()
    for rank, res in enumerate(spawned):
        lat, dev = res[name]
        assert lat.shape == (1, 18, 64)
        if compact is None:
            assert rel_err(lat, one) < BOUND, rank
        else:
            ref, lossless = jax_latents(tuple(RING2.items()), True), jax_latents(tuple(RING2.items()))
            jax_codec_err = rel_err(ref, lossless)
            assert jax_codec_err > 0 and rel_err(lat, spawned[0]["ring2"][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_codec_err, rank
            assert dev == 0.0, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])
    if name == "pp2":
        tv = dataclasses.replace(tvae3d.tiny_vae3d(), latent_channels=16, dtype=torch.float32)
        cfg = ConsisIDPipelineConfig(model=_tm(), vae=tv, num_steps=3, guidance_scale=6.0, **SIZE)
        pipe = ConsisIDPipeline(params_from_numpy(_np(models[1])), None, cfg, "cpu")
        txt, ids, noise = (torch.from_numpy(a) for a in _inputs())
        np.testing.assert_array_equal(spawned[0][name][0],
                                      pipe(txt, latents=noise, id_states=ids, decode=False).numpy())


TINY = ["--model", "consisid-tiny", "--height", "32", "--width", "48", "--num_frames", "9", "--num_inference_steps",
        "2", "--max_sequence_length", "8", "--prompt", "a woman smiling", "--seed", "5"]


def test_tiny_runner_with_and_without_an_identity_image_matches_jax(tmp_path, monkeypatch):
    face = tmp_path / "face.png"
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)).save(face)
    outs = {}
    for argv in (TINY, TINY + ["--img_file_path", str(face)]):
        jr, weights = jax_video_runner(argv)
        tr = port_runner(argv, weights)
        assert tr.family == jr.family == "consisid"
        cfg, inp = jr.pipeline_config, jr.input_config
        noise = np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (1, cfg.tokens, 64), jnp.float32))
        jlat, jvid = np.asarray(jr(decode=False)), np.asarray(jr())
        lat, vid = tr(latents=torch.from_numpy(noise), decode=False), tr(latents=torch.from_numpy(noise))
        assert lat.shape == jlat.shape == (1, 18, 64) and vid.shape == jvid.shape == (1, 5, 8, 12, 3)
        assert rel_err(lat.numpy(), jlat) < BOUND and rel_err(vid.numpy(), jvid) < BOUND
        outs[len(argv)] = lat
        if "--img_file_path" in argv:
            np.testing.assert_array_equal(tr._encode_identity(str(face)).numpy(),
                                          np.asarray(jr._encode_identity(str(face))))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(consisid_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = consisid_example.main(TINY + ["--img_file_path", str(face)])
    assert out.shape == (1, 5, 8, 12, 3) and saved == "results/consisid_rank0.npy"
