"""The whole CogVideoX slice vs the JAX pipeline: ``cogvideox_tiny`` +
``tiny_vae3d``, fp32, 32 x 48 and 9 frames (3 latent frames: 18 video
tokens), 4 v-prediction DDIM steps at guidance 6, the same noise fed to
JAX ``pipe._sample`` and to the port.

* One device: latents and video within 2e-4 (the fp32 bound of
  tests/io/test_backbone_parity.py), plain, with dynamic CFG and at
  ``patch_t=2`` (a padding latent frame, dropped before the decode).
* In one spawn of 2 gloo processes against JAX: ring 2, Ulysses 2 and cfg 2
  lossless within 2e-4 of JAX's one-device run, on the 3D-rope form and
  (ring 2, U2) on the 2B form with its sin-cos table; BINARY and INT2
  (residual 1 + EF, warmup 1, spiced modulation biases, the consistency
  check on), unfused and fused, within a tenth of JAX's own distance from
  its lossless latents (which must be > 0), as
  tests/test_torch_flux_pipeline.py holds FLUX; JAX runs its ppermute ring
  for the fused configurations too.  Each rank holds 9 video rows, an odd
  count, as CogVideoX-2b's 8,775 at ring 2.  EF caches equal on the ring
  peers (deviation 0).
* The geometry errors with JAX's messages (49 x 480 x 720 at Ulysses 2 x
  ring 2 included), the branches left out raise.
* ``xDiTParallel`` on ``cogvideox-tiny`` from a prompt with the JAX runner's
  weights in fp32 and its noise: latents and video within 2e-4; ``save``
  writes ``.npy``; the example; one request to the HTTP service;
  ``--quantize_backbone_int8`` (the codes bit-equal to JAX's).
"""

import base64
import dataclasses
import functools
import io
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu import args as jargs
from compactfusion_tpu import parallel_api as japi
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.models import cogvideox as jcog
from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.cogvideox import CogVideoXPipeline as JPipeline
from compactfusion_tpu.pipelines.cogvideox import CogVideoXPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch import args as targs
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.entrypoints.launch import Engine, make_handler
from compactfusion_tpu_torch.examples import cogvideox_example
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import cogvideox as tcog
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.test_torch_api import _config, _f32, _http, _np
from tests.test_torch_rank_fns import cogvideox_pipeline_latents, port_runner

STEPS = 4
BOUND = 2e-4
SIZE = dict(height=32, width=48, num_frames=9)
COMPACT = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True, check_consistency=True)
CODECS = {"binary": dict(COMPACT, compress_type="binary"), "int2": dict(COMPACT, compress_type="int2")}
RING2 = dict(ring_degree=2)
CONFIGS = ([("ring2 lossless", "rope", RING2, None),
            ("ring2 lossless fused", "rope", dict(RING2, use_fused_ring=True), None),
            ("u2 lossless", "rope", dict(ulysses_degree=2), None), ("cfg2 lossless", "rope", dict(cfg_degree=2), None),
            ("ring2 lossless table", "table", RING2, None),
            ("u2 lossless table", "table", dict(ulysses_degree=2), None)]
           + [(f"ring2 {codec}" + " fused" * fused, "rope", dict(RING2, use_fused_ring=fused), ckw)
              for codec, ckw in CODECS.items() for fused in (False, True)])


def _inputs(tokens=18, token_in=64, seed=1):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((2, 1, 6, 32)).astype(np.float32)
    return txt, rng.standard_normal((1, tokens, token_in)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """{form: (JAX model config, JAX params)}: the 3D-rope form, the 2B form
    (sin-cos table) and the 1.5 form (patch_t 2), spiced; the tiny VAE."""
    out = {}
    for form, patch_t, rotary in (("rope", 1, True), ("table", 1, False), ("patch_t2", 2, True)):
        jm = dataclasses.replace(jcog.cogvideox_tiny(patch_t), use_rotary=rotary, dtype=jnp.float32)
        out[form] = (jm, spice_params(jcog.init_cogvideox(jax.random.PRNGKey(0), jm)))
    jv = dataclasses.replace(jvae3d.tiny_vae3d(), latent_channels=16, dtype=jnp.float32)
    return out, (jv, jvae3d.init_vae3d_decoder(jax.random.PRNGKey(1), jv))


@pytest.fixture(scope="module")
def jax_run(models):
    forms, (jv, jvae) = models
    cache = {}

    def run(form, parallel=None, compact=None, dynamic=False):
        parallel = parallel or {}
        key = (form, tuple(sorted(parallel.items())), compact and compact["compress_type"], dynamic)
        if key not in cache:
            jm, jp = forms[form]
            jc = JPipelineConfig(model=jm, parallel=JParallel(**parallel), num_steps=STEPS, use_dynamic_cfg=dynamic,
                                 compact=JCompact(**dict(compact, compress_type=JType(compact["compress_type"])))
                                 if compact else JCompact(), **SIZE)
            n = JParallel(**parallel).world_size
            pipe = JPipeline(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:n]), vae_params=jvae, vae_cfg=jv)
            txt, noise = _inputs(jc.tokens, jm.token_in)
            lat = np.asarray(pipe._sample(jp, jnp.asarray(txt), jnp.asarray(noise)))
            cache[key] = (lat, np.asarray(pipe._decode(jvae, jnp.asarray(lat))))
        return cache[key]

    return run


def _port(models, form, **kw):
    forms, (jv, jvae) = models
    jm, jp = forms[form]
    tm = dataclasses.replace(tcog.cogvideox_tiny(jm.patch_t), use_rotary=jm.use_rotary, dtype=torch.float32)
    tv = dataclasses.replace(tvae3d.tiny_vae3d(), latent_channels=16, dtype=torch.float32)
    cfg = CogVideoXPipelineConfig(model=tm, vae=tv, num_steps=STEPS, **SIZE, **kw)
    return CogVideoXPipeline(params_from_numpy(_np(jp)), params_from_numpy(_np(jvae)), cfg, "cpu")


@pytest.mark.parametrize("case", ["plain", "dynamic-cfg", "table", "patch_t2"])
def test_tiny_pipeline_matches_jax(models, jax_run, case):
    form = {"plain": "rope", "dynamic-cfg": "rope"}.get(case, case)
    dynamic = case == "dynamic-cfg"
    jlat, jvid = jax_run(form, dynamic=dynamic)
    pipe = _port(models, form, use_dynamic_cfg=dynamic)
    cfg = pipe.cfg
    assert (cfg.tokens, cfg.pad_latent_frames) == ((18, 0) if form != "patch_t2" else (12, 1))
    txt, noise = (torch.from_numpy(a) for a in _inputs(cfg.tokens, cfg.model.token_in))
    lat = pipe(txt, latents=noise, decode=False)
    vid = pipe.decode(lat)
    assert lat.shape == jlat.shape and vid.shape == jvid.shape == (1, 5, 8, 12, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND
    assert rel_err(vid.numpy(), jvid) < BOUND
    assert vid.min() >= 0.0 and vid.max() <= 1.0
    if case == "plain":
        # dynamic guidance moves the latents; the generator path repeats itself
        assert rel_err(jax_run(form, dynamic=True)[0], jlat) > 1e-3
        a = pipe(txt, generator=torch.Generator().manual_seed(3))
        assert a.shape == (1, 5, 8, 12, 3) and torch.equal(a, pipe(txt, generator=torch.Generator().manual_seed(3)))
        with pytest.raises(ValueError):
            pipe(txt)


@pytest.fixture(scope="module")
def spawned(models):
    forms, _ = models
    spec = {form: (forms[form][0].use_rotary, _np(forms[form][1])) for form in ("rope", "table")}
    return tmesh.spawn_local(cogvideox_pipeline_latents, 2, "gloo", CONFIGS, spec, _inputs(), threads=1,
                             timeout=300)


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_cogvideox_across_ranks_matches_jax(spawned, jax_run, config):
    name, form, par, compact = config
    one = jax_run(form)[0]
    for rank, res in enumerate(spawned):
        lat, dev = res[name]
        assert lat.shape == (1, 18, 64)
        if compact is None:
            assert rel_err(lat, one) < BOUND, rank
        else:
            ref, lossless = jax_run(form, RING2, compact)[0], jax_run(form, RING2)[0]
            jax_codec_err = rel_err(ref, lossless)
            assert jax_codec_err > 0 and rel_err(lat, res["ring2 lossless"][0]) > 0
            assert rel_err(lat, ref) < 0.1 * jax_codec_err, rank
            assert dev == 0.0, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])


def test_geometry_errors_match_jax_and_unported_branches_raise():
    cases = [(dict(ulysses_degree=2, ring_degree=2), dict(height=480, width=720, num_frames=49), "2b"),
             (dict(ulysses_degree=4), dict(height=480, width=720, num_frames=49), "2b"),
             (dict(ring_degree=4), SIZE, "tiny"), (dict(pp_degree=4), SIZE, "tiny")]
    for par, size, model in cases:
        jm = jcog.cogvideox_2b() if model == "2b" else jcog.cogvideox_tiny()
        tm = tcog.cogvideox_2b() if model == "2b" else tcog.cogvideox_tiny()
        with pytest.raises(ValueError) as jerr:
            JPipelineConfig(model=jm, parallel=JParallel(**par), **size)
        with pytest.raises(ValueError) as terr:
            CogVideoXPipelineConfig(model=tm, parallel=ParallelConfig(**par), **size)
        assert str(terr.value) == str(jerr.value)
    # 17,550 tokens split over ring 2, Ulysses 2 and cfg 2; an even latent frame count splits over U2 x R2
    for par in (dict(ring_degree=2), dict(ulysses_degree=2), dict(cfg_degree=2)):
        assert CogVideoXPipelineConfig(model=tcog.cogvideox_2b(), parallel=ParallelConfig(**par)).tokens == 17550
    four = CogVideoXPipelineConfig(model=tcog.cogvideox_2b(), parallel=ParallelConfig(ulysses_degree=2, ring_degree=2),
                                   num_frames=5)
    assert four.grid == (2, 30, 45)
    # PipeFusion and TP are ported: the configs build, the pipelines need this rank's mesh
    for par in (dict(pp_degree=2), dict(tp_degree=2)):
        staged = CogVideoXPipelineConfig(model=tcog.cogvideox_tiny(), parallel=ParallelConfig(**par), **SIZE)
        with pytest.raises(ValueError, match="mesh"):
            CogVideoXPipeline({}, None, staged, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        CogVideoXPipeline({}, None, CogVideoXPipelineConfig(model=tcog.cogvideox_tiny(),
                                                            parallel=ParallelConfig(ring_degree=2), **SIZE), "cpu")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

TINY = ["--model", "cogvideox-tiny", "--height", "32", "--width", "48", "--num_frames", "9", "--num_inference_steps",
        "3", "--max_sequence_length", "8", "--prompt", "a cat", "--seed", "5"]


def _jax_runner(argv):
    """The JAX runner from a command line moved to fp32 (backbone, 3D VAE,
    T5; int8 codes stay int8), and its weights as numpy trees."""
    jr = japi.xDiTParallel(*_config(jargs, argv))
    pcfg = jr.pipeline_config
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, dtype=jnp.float32))
    vcfg = dataclasses.replace(jr.pipeline.vae_cfg, dtype=jnp.float32)
    params, vae = _f32(jr.pipeline.params), _f32(jr.pipeline.vae_params)
    jr.pipeline = JPipeline(params, cfg, jr.pipeline.mesh, vae_params=vae, vae_cfg=vcfg)
    jr.pipeline_config = cfg
    enc = jr.prompt_encoder
    enc.t5.params = _f32(enc.t5.params)
    enc.t5.cfg = dataclasses.replace(enc.t5.cfg, dtype=jnp.float32)
    enc._jit_t5, enc._jit_clip = None, {}
    return jr, {"params": _np(params), "vae": _np(vae), "t5": _np(enc.t5.params)}


@pytest.fixture(scope="module")
def jax_runners():
    return {"bf16": _jax_runner(TINY), "int8": _jax_runner(TINY + ["--quantize_backbone_int8"])}


def _jax_noise(jr):
    cfg, inp = jr.pipeline_config, jr.input_config
    return np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (len(inp.prompt), cfg.tokens, cfg.model.token_in),
                                      jnp.float32))


@pytest.mark.parametrize("which", ["bf16", "int8"])
def test_tiny_runner_matches_jax(jax_runners, which, tmp_path):
    jr, weights = jax_runners[which]
    argv = TINY + (["--quantize_backbone_int8"] if which == "int8" else [])
    tr = port_runner(argv, weights)
    assert tr.family == "cogvideox" and tr.pipeline_config.num_frames == 9
    noise = torch.from_numpy(_jax_noise(jr))
    jlat, jvid = np.asarray(jr(decode=False)), np.asarray(jr())
    lat = tr(latents=noise, decode=False)
    vid = tr(latents=noise)
    assert lat.shape == jlat.shape == (1, 18, 64) and vid.shape == jvid.shape == (1, 5, 8, 12, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND
    assert rel_err(vid.numpy(), jvid) < BOUND
    if which == "int8":
        assert tr.pipeline.params["blocks"]["qkv"]["w_q"].dtype == torch.int8
        # the port's own quantization of the fp32 weights gives JAX's codes
        own = port_runner(TINY, jax_runners["bf16"][1])
        own._quantize_backbone_int8()
        for key in ("qkv", "attn_out", "mod_attn"):
            np.testing.assert_array_equal(own.pipeline.params["blocks"][key]["w_q"].numpy(),
                                          weights["params"]["blocks"][key]["w_q"])
        return
    # save: a video is written as .npy, one per rank
    path = tr.save(str(tmp_path), out=vid)
    assert path.endswith("cftpu_rank0.npy")
    np.testing.assert_array_equal(np.load(path), vid.numpy())
    assert torch.equal(tr(), tr())


def test_example_and_service_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cogvideox_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = cogvideox_example.main(TINY + ["--num_inference_steps", "2"])
    assert out.shape == (1, 5, 8, 12, 3) and saved == "results/cogvideox_rank0.npy"
    np.testing.assert_array_equal(np.load(tmp_path / saved), out.float().numpy())

    parser = targs.FlexibleArgumentParser()
    targs.xFuserArgs.add_cli_args(parser)
    engine = Engine(targs.xFuserArgs.from_cli_args(parser.parse_args(TINY)), serve_batch=1, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        code, r = _http(f"http://127.0.0.1:{server.server_address[1]}/generate", {"prompt": "a dog", "seed": 2})
        assert code == 200 and r["media_type"] == "application/x-npy" and r["shape"] == [1, 5, 8, 12, 3]
        video = np.load(io.BytesIO(base64.b64decode(r["output"])))
        assert video.shape == (1, 5, 8, 12, 3) and np.isfinite(video).all()
        assert 0.0 <= video.min() and video.max() <= 1.0
    finally:
        server.shutdown()
        engine.close()


@pytest.mark.parametrize("rows", [8775, 17550])
def test_odd_row_payloads_arrive_aligned_for_the_vector_plan(rows):
    """A fault the chip run found: a rank of CogVideoX-2b's ring sends
    payloads of 8,775 or 17,550 rows, whose (N, 1) bf16 scales end 16-byte
    misaligned inside the packed buffer, so the next leaf arrived at an odd
    offset and the dequant of every K took the scalar plan.  Unpacked
    leaves now start 16-byte aligned, with the same values and wire bytes."""
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import quant
    from compactfusion_tpu_torch.parallel.mesh import pack_tree

    g = torch.Generator().manual_seed(rows)
    c = 64  # 8 packed bytes a row: the vector plan's multiple of 4
    payloads = tuple(codecs.encode(torch.randn((rows, c), generator=g), codecs.CompressType(codec))
                     for codec in ("binary", "binary", "int2"))
    flat, unpack = pack_tree(payloads)
    assert flat.numel() == sum(codecs.payload_nbytes(p) for p in payloads)
    base = torch.zeros((rows, c))
    for got in (unpack(flat.clone()), unpack(torch.stack([flat, flat]))):
        for sent, arrived in zip(payloads, got):
            for a, b in zip(sent, arrived):
                assert b.data_ptr() % 16 == 0
                torch.testing.assert_close(b if b.dim() == a.dim() else b[1], a, rtol=0, atol=0)
    for (packed, _, v), per_byte in zip(unpack(flat.clone()), (8, 8, 4)):
        assert quant.quant_plan(per_byte, base, v, packed=packed) == quant.QUANT_VEC_BYTES
