"""The port's entry points against the JAX package's: ``xFuserArgs`` ->
``create_config``, resolution binning, ``resize_and_crop``, the registry,
the ``xDiTParallel`` runner, ``save``, the HTTP service and the int8 and
DiTFastAttn switches.

The tiny runners (64 x 64, 3 steps, ``max_sequence_length`` 8) take the
JAX runner's weights (backbone, VAE, text encoders) across in fp32 and the
JAX runner's noise as ``latents=``: latents and images within 2e-4, the
fp32 bound of tests/io/test_backbone_parity.py.  Ring 2 runs in 2 gloo
processes against JAX's 2-device CPU mesh; the compressed run within a
tenth of JAX's own distance from its lossless latents, as
tests/test_torch_pipeline_ring.py holds the pipeline.
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from compactfusion_tpu import args as jargs
from compactfusion_tpu import parallel_api as japi
from compactfusion_tpu_torch import args as targs
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import CompressType
from compactfusion_tpu_torch.entrypoints.launch import Engine, make_handler
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.utils.image import read_png, to_uint8
from tests.helpers import rel_err, spice_params
from tests.test_torch_rank_fns import port_runner, runner_latents

BOUND = 2e-4
TINY = ["--height", "64", "--width", "64", "--num_inference_steps", "3", "--max_sequence_length", "8",
        "--prompt", "a cat", "--seed", "5"]
PIXART = ["--model", "pixart-tiny"] + TINY
FLUX = ["--model", "flux-tiny"] + TINY


def _config(mod, argv):
    parser = mod.FlexibleArgumentParser()
    mod.xFuserArgs.add_cli_args(parser)
    return mod.xFuserArgs.from_cli_args(parser.parse_args(argv)).create_config()


def _plain(obj):
    """A config tree as nested plain values (enums by value) to compare."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return getattr(obj, "value", obj)


# tests/core/test_args.py's argument lists, plus the ignored flags
ARGVS = {
    "reference-style": ["--model", "black-forest-labs/FLUX.1-dev", "--ulysses_degree", "2", "--ring_degree", "2",
                        "--height", "1024", "--width=1024", "--num-inference-steps", "28",
                        "--prompt", "a photo of a cat"],
    "cfg-compact": ["--use_cfg_parallel", "--compact", "--compact_type", "int2", "--compact_warmup_steps", "3"],
    "world-size": ["--ulysses_degree", "2", "--ring_degree", "2", "--use_cfg_parallel"],
    "ignored-flags": ["--use_ray", "--use_onediff", "--enable_model_cpu_offload", "--enable_sequential_cpu_offload",
                      "--use_torch_compile", "--use_cuda_graph", "--attn_layer_num_for_pp", "2", "2",
                      "--ray_world_size", "4", "--dit_parallel_size", "2"],
    "int8-and-fast-attn": ["--use_int8_t5_encoder", "--quantize_backbone_int8", "--use_fast_attn", "--threshold",
                           "0.35", "--window_size", "4", "--n_calib", "3", "--use_cache"],
    "fp8-t5-and-caches": ["--use_fp8_t5_encoder", "--use_fbcache", "--use_teacache", "--output_type", "latent",
                          "--no_use_resolution_binning", "--negative_prompt", "blurry", "ugly"],
    "compact-patch": ["--compact", "--compact_type", "low-rank", "--compact_rank", "4", "--compact_patch_gather",
                      "--compact_patch_async", "--compact_residual", "2", "--use_fused_ring",
                      "--data_parallel_degree", "2", "--prompt", "a", "b"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_create_config_matches_jax(name):
    argv = ARGVS[name]
    (je, ji), (te, ti) = _config(jargs, argv), _config(targs, argv)
    assert _plain(te) == _plain(je)
    assert _plain(ti) == _plain(ji)
    assert te.parallel_config.world_size == je.parallel_config.world_size
    if name == "cfg-compact":
        assert te.compact_config.compress_type is CompressType.INT2


def test_resolution_bins_match_jax():
    for base in (64, 512, 1024):
        for h in range(48, 2 * base + 1, max(8, base // 16)):
            for w in (base // 2, base - 24, base, base + 40, 2 * base):
                assert tapi.classify_height_width_bin(h, w, base) == japi.classify_height_width_bin(h, w, base)


@pytest.mark.parametrize("size", [(37, 53), (16, 16), (100, 64), (48, 96)])
def test_resize_and_crop_matches_jax(size):
    x = np.random.default_rng(2).random((2, 24, 32, 3)).astype(np.float32)
    want = np.asarray(japi.resize_and_crop(jnp.asarray(x), *size))
    got = tapi.resize_and_crop(torch.from_numpy(x), *size).numpy()
    assert got.shape == want.shape == (2, *size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


NAMES = ["PixArt-alpha/PixArt-XL-2-512x512", "pixart-tiny", "black-forest-labs/FLUX.1-dev", "FLUX.1-schnell",
         "flux-tiny", "stabilityai/stable-diffusion-3-medium", "sd3-tiny", "THUDM/CogVideoX-2b", "cogvideox1.5-tiny",
         "maxin-cn/Latte-1", "tencent/HunyuanVideo", "BestWishYsh/ConsisID-preview", "stepfun-ai/stepvideo-t2v",
         "step_video", "Tencent-Hunyuan/HunyuanDiT-v1.2", "hunyuanvideo-tiny", "hunyuandit-tiny"]


def test_registry_resolves_every_name_jax_resolves(monkeypatch):
    assert [(f.name, f.pattern) for f in tapi._REGISTRY.values()] == \
        [(f.name, f.pattern) for f in japi._REGISTRY.values()]
    for name in NAMES:
        assert tapi.resolve_family(name).name == japi.resolve_family(name).name, name
    for mod in (tapi, japi):
        with pytest.raises(ValueError, match="no pipeline registered"):
            mod.resolve_family("stable-cascade")
    engine, inp = _config(targs, ["--model", "sd3-tiny"])
    # every family is ported: each registered build function is a family's own,
    # Step-Video's among them
    assert all(f.build.__name__ == f"_build_{'hunyuan' if n == 'hunyuandit' else n}"
               for n, f in tapi._REGISTRY.items())
    from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipeline

    sv_engine, sv_inp = _config(targs, ["--model", "stepvideo-tiny", "--height", "128", "--width", "128",
                                        "--num_frames", "17"])
    sv_pipe, sv_cfg = tapi._REGISTRY["stepvideo"].build(sv_engine, sv_inp, None, "cpu")
    assert isinstance(sv_pipe, StepVideoPipeline) and sv_cfg.tokens == 48
    # SD3 and HunyuanDiT are ported: their builders give the pipelines
    # JAX's give, per name, with the VAE knobs on
    from compactfusion_tpu.models import hunyuandit as jhy
    from compactfusion_tpu.models import sd3 as jsd3
    from compactfusion_tpu.models import vae as jvae
    from compactfusion_tpu_torch.pipelines.hunyuandit import HunyuanDiTPipeline
    from compactfusion_tpu_torch.pipelines.sd3 import SD3Pipeline

    def same(port_cfg, jax_cfg):
        strip = lambda c: {k: v for k, v in _plain(c).items() if k != "dtype"}  # noqa: E731
        return strip(port_cfg) == strip(jax_cfg)

    for name, cls, (jm, jv) in (
            ("sd3-tiny", SD3Pipeline, (jsd3.sd3_tiny(), dataclasses.replace(jvae.tiny_vae(), latent_channels=4))),
            ("hunyuandit-tiny", HunyuanDiTPipeline, (jhy.hunyuandit_tiny(), jvae.tiny_vae()))):
        e, i = _config(targs, ["--model", name, "--height", "64", "--width", "64", "--enable_tiling",
                               "--enable_slicing"])
        pipe, pcfg = tapi._REGISTRY[tapi.resolve_family(name).name].build(e, i, None, "cpu")
        assert isinstance(pipe, cls) and same(pcfg.model, jm)
        assert same(pcfg.vae, dataclasses.replace(jv, use_tiling=True, use_slicing=True))
    from compactfusion_tpu.models import pixart as jpix
    from compactfusion_tpu_torch.models import hunyuandit as thy
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import sd3 as tsd3
    from compactfusion_tpu_torch.models import vae as tvae

    for mod, fn in ((tsd3, "init_sd3"), (thy, "init_hunyuandit"), (tpix, "init_pixart"), (tvae, "init_vae_decoder")):
        monkeypatch.setattr(mod, fn, lambda gen, cfg: {})
    sdxl = dataclasses.replace(jvae.sd_vae(), scaling_factor=0.13025)
    for argv, family, jm, jv in (
            (["--model", "stabilityai/stable-diffusion-3-medium"], "sd3", jsd3.sd3_medium(), jvae.sd3_vae()),
            (["--model", "Tencent-Hunyuan/HunyuanDiT-v1.2"], "hunyuandit", jhy.hunyuandit_v12(), sdxl),
            (["--model", "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS"], "pixart", jpix.pixart_sigma_1024(), sdxl),
            (["--model", "pixart", "--height", "1024"], "pixart", jpix.pixart_sigma_1024(), sdxl),
            (["--model", "PixArt-alpha/PixArt-Sigma-XL-2-2K-MS", "--height", "2048", "--width", "2048"], "pixart",
             jpix.pixart_sigma_2k(), sdxl),
            (["--model", "pixart", "--height", "1536", "--width", "1536"], "pixart", jpix.pixart_sigma_2k(), sdxl),
            (["--model", "PixArt-alpha/PixArt-XL-2-512x512"], "pixart", jpix.pixart_alpha_512(), jvae.sd_vae())):
        e, i = _config(targs, argv + ["--enable_tiling"])
        _, pcfg = tapi._REGISTRY[family].build(e, i, None, "cpu")
        assert same(pcfg.model, jm) and same(pcfg.vae, dataclasses.replace(jv, use_tiling=True)), argv
        if family == "pixart":  # binned at the model's native area
            base = jm.sample_size * 8
            assert (pcfg.height, pcfg.width) == japi.classify_height_width_bin(i.height, i.width, base)
    # CogVideoX is ported: its builder gives the pipeline JAX's gives, per name
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    for name, (dim, patch_t, rotary) in (("cogvideox-tiny", (64, 1, True)), ("cogvideox1.5-tiny", (64, 2, True))):
        e, i = _config(targs, ["--model", name, "--height", "32", "--width", "48", "--num_frames", "9"])
        pipe, pcfg = tapi._REGISTRY["cogvideox"].build(e, i, None, "cpu")
        assert isinstance(pipe, CogVideoXPipeline) and pcfg.num_frames == 9
        assert (pcfg.model.dim, pcfg.model.patch_t, pcfg.model.use_rotary) == (dim, patch_t, rotary)
    # the full-size configs by name, with --enable_tiling, without drawing their weights
    from compactfusion_tpu_torch.models import cogvideox as tcog
    from compactfusion_tpu_torch.models import vae3d as tvae3d

    monkeypatch.setattr(tcog, "init_cogvideox", lambda gen, cfg: {})
    monkeypatch.setattr(tvae3d, "init_vae3d_decoder", lambda gen, cfg: {})
    for name, want in (("THUDM/CogVideoX-2b", tcog.cogvideox_2b()), ("THUDM/CogVideoX-5b", tcog.cogvideox_5b()),
                       ("THUDM/CogVideoX1.5-5B", tcog.cogvideox_1_5_5b())):
        e, i = _config(targs, ["--model", name, "--num_frames", "49", "--height", "480", "--width", "720",
                               "--enable_tiling"])
        _, pcfg = tapi._REGISTRY["cogvideox"].build(e, i, None, "cpu")
        assert pcfg.model == want and pcfg.vae == dataclasses.replace(tvae3d.cogvideox_vae(), use_tiling=True)
    # the VAE memory knobs run through the runner: tiling and slicing pass
    # the tiny latents through to the dense decode, bit for bit
    monkeypatch.undo()
    plain = tapi.xDiTParallel(*_config(targs, PIXART), device="cpu")
    dense, dense_latents = plain(), plain(decode=False)
    for knob in ("--enable_tiling", "--enable_slicing"):
        run = tapi.xDiTParallel(*_config(targs, PIXART + [knob]), device="cpu")
        assert run.pipeline_config.vae.use_tiling == (knob == "--enable_tiling")
        assert torch.equal(run(), dense)
    # the identity image is read by ConsisID alone; PixArt ignores it, as in JAX
    with_img = tapi.xDiTParallel(*_config(targs, PIXART + ["--img_file_path", "x.png"]), device="cpu")
    assert torch.equal(with_img(decode=False), dense_latents)
    # num_frames is read by the video families; PixArt ignores it, as in JAX
    five = tapi.xDiTParallel(*_config(targs, PIXART + ["--num_frames", "5"]), device="cpu")
    assert five.pipeline_config == tapi.xDiTParallel(*_config(targs, PIXART), device="cpu").pipeline_config
    assert five(decode=False).shape == (1, 16, 16)
    # no CPU path unless the caller asks for it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.xDiTParallel(*_config(targs, PIXART))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                                  tree)


def jax_runner(argv, spice=False, configure=None):
    """The JAX runner from a command line, moved to fp32 (backbone, VAE and
    text encoders; int8 codes stay int8), and its weights as numpy trees.
    ``configure(engine, input)`` returns the configs to build it from, as an
    example script edits them after ``create_config``."""
    e, i = _config(jargs, argv)
    if configure is not None:
        e, i = configure(e, i)
    jr = japi.xDiTParallel(e, i)
    pcfg = jr.pipeline_config
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, dtype=jnp.float32),
                              vae=dataclasses.replace(pcfg.vae, dtype=jnp.float32))
    params = _f32(jr.pipeline.params)
    if spice:
        params = spice_params(params)
    jr.pipeline = type(jr.pipeline)(params, _f32(jr.pipeline.vae_params), cfg, jr.pipeline.mesh)
    jr.pipeline_config = cfg
    enc = jr.prompt_encoder
    weights = {"params": _np(params), "vae": _np(jr.pipeline.vae_params)}
    for name in ("t5", "clip_l"):
        bundle = getattr(enc, name)
        if bundle is not None:
            bundle.params = _f32(bundle.params)
            bundle.cfg = dataclasses.replace(bundle.cfg, dtype=jnp.float32)
            weights[name] = _np(bundle.params)
    enc._jit_t5, enc._jit_clip = None, {}
    return jr, weights


def jax_noise(jr):
    """The noise the JAX runner draws from the request seed."""
    cfg, inp = jr.pipeline_config, jr.input_config
    m = cfg.model
    width = m.in_channels if jr.family == "flux" else m.patch * m.patch * m.in_channels
    return np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (len(inp.prompt), cfg.tokens, width),
                                      jnp.float32))


@pytest.fixture(scope="module")
def jax_pixart():
    return jax_runner(PIXART)


@pytest.mark.parametrize("family", ["pixart", "flux", "pixart-int8", "flux-int8"])
def test_tiny_runner_matches_jax(family, jax_pixart):
    argv = {"pixart": PIXART, "flux": FLUX}[family.split("-")[0]]
    if family.endswith("int8"):
        argv = argv + ["--quantize_backbone_int8"]
    jr, weights = jax_pixart if family == "pixart" else jax_runner(argv)
    tr = port_runner(argv, weights)
    if family.endswith("int8"):
        blocks, key = ("blocks", "attn_qkv") if family.startswith("pixart") else ("double_blocks", "img_qkv")
        assert tr.pipeline.params[blocks][key]["w_q"].dtype == torch.int8
    noise = torch.from_numpy(jax_noise(jr))
    jlat, jimg = np.asarray(jr(decode=False)), np.asarray(jr())
    lat = tr(latents=noise, decode=False)
    img = tr(latents=noise)
    assert lat.shape == jlat.shape and img.shape == jimg.shape == (1, 16, 16, 3)
    assert rel_err(lat.numpy(), jlat) < BOUND
    assert rel_err(img.numpy(), jimg) < BOUND
    # the generator path: the request seed, the same image twice
    assert torch.equal(tr(), tr())


def test_output_type_latent_prepare_run_and_save(tmp_path):
    runner = port_runner(PIXART + ["--output_type", "latent", "--prompt", "a cat", "a dog"])
    lat = runner.prepare_run()()
    assert lat.shape == (2, 16, 16) and torch.isfinite(lat).all()
    assert runner.save(str(tmp_path), out=lat).endswith("cftpu_rank0.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "cftpu_rank0.npy"), lat.numpy())
    runner.input_config = dataclasses.replace(runner.input_config, output_type="pil")
    img = runner()
    paths = runner.save(str(tmp_path), prefix="img", out=img)
    assert [p.rsplit("/", 1)[1] for p in paths] == ["img_rank0_0.png", "img_rank0_1.png"]
    want = to_uint8(img.float().numpy())
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), want[i])
        with open(p, "rb") as f:
            np.testing.assert_array_equal(read_png(f.read()), want[i])


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_service(tmp_path):
    parser = targs.FlexibleArgumentParser()
    targs.xFuserArgs.add_cli_args(parser)
    engine = Engine(targs.xFuserArgs.from_cli_args(parser.parse_args(PIXART)), serve_batch=2, device="cpu")
    engine.batch_window_s = 1.0
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert engine.batch_size == 2
        assert _http(base + "/health") == (200, {"status": "ok"})
        code, r = _http(base + "/generate", {"prompt": "a red cube", "seed": 3, "height": 999,
                                             "num_inference_steps": 50})
        assert code == 200 and r["media_type"] == "image/png" and r["shape"] == [1, 16, 16, 3]
        assert r["ignored_fields"] == ["height", "num_inference_steps"] and r["latency_s"] >= 0
        png = base64.b64decode(r["images"][0])
        assert np.asarray(Image.open(io.BytesIO(png))).shape == (16, 16, 3)
        assert _http(base + "/generate", {"prompt": "a red cube", "seed": 3})[1]["images"] == r["images"]
        code, r = _http(base + "/generate", {"prompt": "a cat", "save_disk_path": str(tmp_path / "out")})
        assert code == 200 and r["save_to_disk"] and "ignored_fields" not in r
        with open(r["output"], "rb") as f:
            assert read_png(f.read()).shape == (16, 16, 3)
        # 4 concurrent clients at serve_batch 2: packed 2 to a call
        before = dict(engine.stats)
        results = [None] * 4
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait()
            results[i] = _http(base + "/generate", {"prompt": f"prompt {i}", "seed": 7})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(code == 200 and len(r["images"]) == 1 for code, r in results)
        assert engine.stats["max_packed"] == 2
        assert engine.stats["batches"] - before["batches"] < 4
        assert engine.stats["requests"] - before["requests"] == 4
        assert _http(base + "/stats")[1]["batch_size"] == 2
        assert _http(base + "/nothing")[0] == 404

        def dead():
            raise RuntimeError("device lost")

        engine._device_probe, engine._health_max_age_s = dead, 0.0
        assert _http(base + "/health")[0] == 503
    finally:
        server.shutdown()
        engine.close()


def test_int8_switches_within_jax_bounds():
    ref = port_runner(PIXART)
    q = port_runner(PIXART + ["--quantize_backbone_int8", "--use_int8_t5_encoder"])
    assert q.pipeline.params["blocks"]["attn_qkv"]["w_q"].dtype == torch.int8
    # zero AdaLN gates hide the blocks: spice the tables, then quantize as the flag does
    rng = np.random.default_rng(9)
    blocks = ref.pipeline.params["blocks"]
    blocks["scale_shift_table"] = torch.from_numpy(
        rng.standard_normal(tuple(blocks["scale_shift_table"].shape)) * 0.5).to(torch.bfloat16)
    q.pipeline.params = dict(ref.pipeline.params)
    q._quantize_backbone_int8()
    assert q.prompt_encoder.t5.params["embed_q"].dtype == torch.int8
    # tests/core/test_parallel_api.py: int8 backbone latents within 0.1
    out, want = q(decode=False), ref(decode=False)
    assert torch.isfinite(out).all() and 0.0 < rel_err(out.numpy(), want.numpy()) < 0.1
    # tests/io/test_t5_int8.py: close to the full weights, and not them
    a = q.prompt_encoder.encode_t5(["a photo of a cat"], 16)[0].numpy()
    b = ref.prompt_encoder.encode_t5(["a photo of a cat"], 16)[0].numpy()
    assert 1e-6 < rel_err(a, b) < 0.05


def test_fast_attn_plan_matches_jax(jax_pixart, tmp_path, monkeypatch):
    from compactfusion_tpu.config import FastAttnConfig as JFast
    from compactfusion_tpu_torch.config import FastAttnConfig

    jr, weights = jax_pixart
    kw = dict(use_fast_attn=True, threshold=0.35, window_size=4)
    plain = jr.pipeline, jr.pipeline_config
    jr._apply_fast_attn(JFast(**kw))
    jplan, jlat = jr.pipeline_config.fast_attn_plan, np.asarray(jr(decode=False))
    jr.pipeline, jr.pipeline_config = plain
    tr = port_runner(PIXART, weights)
    monkeypatch.chdir(tmp_path)
    tr._apply_fast_attn(FastAttnConfig(use_cache=True, **kw), latents=torch.from_numpy(jax_noise(jr)))
    assert tr.pipeline_config.fast_attn_plan == jplan
    plan = np.asarray(tr.pipeline_config.fast_attn_plan)
    assert plan.shape == (3, 2) and (plan != 0).any()
    cached = tmp_path / ".cftpu_fastattn_torch_pixart-tiny_3s_2l_w4_t0.35.json"
    assert json.loads(cached.read_text()) == plan.tolist()
    assert tr.pipeline.cfg.fast_attn_window == 4
    noise = torch.from_numpy(jax_noise(jr))
    assert rel_err(tr(latents=noise, decode=False).numpy(), jlat) < BOUND


RING2 = PIXART + ["--ring_degree", "2"]
BINARY2 = RING2 + ["--compact", "--compact_type", "binary", "--compact_warmup_steps", "1"]
# PixArt's PipeFusion defaults to the patch pipeline with M = pp (2 here)
PP2 = PIXART + ["--pipefusion_parallel_degree", "2"]
TP2 = PIXART + ["--tensor_parallel_degree", "2"]
FAST_ATTN = ["--use_fast_attn", "--window_size", "4"]
#: a (3 steps, 2 layers) DiTFastAttn plan that both runners find cached at
#: threshold 0.5 (layer 0 FULL, WINDOW, SHARE; layer 1 FULL, FULL_CFG,
#: WINDOW_CFG), each package under its own file name
CACHED_PLAN = [[0, 0], [1, 3], [2, 4]]
PLAN_FILES = (".cftpu_fastattn_torch_pixart-tiny_3s_2l_w4_t0.5.json", ".cftpu_fastattn_pixart-tiny_3s_2l_w4_t0.5.json")
RUNS2 = [("lossless", RING2), ("binary", BINARY2), ("pp2", PP2), ("tp2", TP2),
         ("tp2-fast-attn", TP2 + FAST_ATTN + ["--use_cache"]), ("pp2-fast-attn", PP2 + FAST_ATTN),
         ("tp2-fast-attn-no-plan", TP2 + FAST_ATTN + ["--use_cache", "--threshold", "0.25"])]


@pytest.fixture(scope="module")
def runners2(tmp_path_factory):
    """The JAX runners of the 2-rank command lines (one weight tree, the
    lossless ring's) and the port's in 2 gloo processes, all run from a
    directory that holds :data:`CACHED_PLAN` under :data:`PLAN_FILES`."""
    plan_dir = tmp_path_factory.mktemp("plans")
    for name in PLAN_FILES:
        (plan_dir / name).write_text(json.dumps(CACHED_PLAN))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(plan_dir)
        jl, weights = jax_runner(RING2, spice=True)
        jax_runs = {"lossless": jl}
        for name, argv in RUNS2[1:5]:
            jr, _ = jax_runner(argv, spice=True)
            jr.pipeline = type(jr.pipeline)(jl.pipeline.params, jl.pipeline.vae_params, jr.pipeline_config,
                                            jr.pipeline.mesh)
            jax_runs[name] = jr
    assert jax_runs["tp2-fast-attn"].pipeline_config.fast_attn_plan == tuple(map(tuple, CACHED_PLAN))
    noise = jax_noise(jl)
    want = {name: np.asarray(jr(decode=False)) for name, jr in jax_runs.items()}
    ranks = tmesh.spawn_local(runner_latents, 2, "gloo", RUNS2, weights, noise, str(plan_dir), threads=1,
                              timeout=300)
    return want, ranks


def test_ring2_runner_matches_jax_cpu_mesh(runners2):
    want, ranks = runners2
    want_l, want_b = want["lossless"], want["binary"]
    for r in ranks:
        assert rel_err(r["lossless"]["latents"], want_l) < BOUND
        jax_err = rel_err(want_b, want_l)
        assert jax_err > 0 and rel_err(r["binary"]["latents"], want_b) < 0.1 * jax_err
    np.testing.assert_array_equal(ranks[0]["binary"]["latents"], ranks[1]["binary"]["latents"])
    assert ranks[0]["binary"]["wire_bytes"] < ranks[0]["lossless"]["wire_bytes"]


def test_pp2_and_tp2_runners_match_jax_cpu_mesh(runners2):
    """``--pipefusion_parallel_degree 2`` (PixArt: the patch pipeline, M =
    2, one sync warmup step) and ``--tensor_parallel_degree 2`` from the
    command line, against JAX's runners on 2 CPU devices.  DiTFastAttn at
    tp 2 runs the cached plan, as JAX's runner does; at tp 2 without a
    cached plan (none at that threshold) and at pp 2 it is ignored with a
    warning: the plain latents."""
    want, ranks = runners2
    for r in ranks:
        for name in ("pp2", "tp2", "tp2-fast-attn"):
            assert rel_err(r[name]["latents"], want[name]) < BOUND, name
        # the plan ran: not the plain tp-2 latents
        assert rel_err(r["tp2-fast-attn"]["latents"], r["tp2"]["latents"]) > 1e-6
        assert r["tp2"]["warnings"] == r["tp2-fast-attn"]["warnings"] == []
        for name, plain, why in (("tp2-fast-attn-no-plan", "tp2", "runs only a cached plan"),
                                 ("pp2-fast-attn", "pp2", "needs sp/pp degree 1")):
            np.testing.assert_array_equal(r[name]["latents"], r[plain]["latents"])
            assert len(r[name]["warnings"]) == 1 and why in r[name]["warnings"][0], r[name]["warnings"]
    # the patch pipeline is not the sync one: the stale K/V is used
    assert rel_err(want["pp2"], want["lossless"]) > 1e-6


def test_calibration_needs_one_device_in_both():
    """Both packages calibrate DiTFastAttn in one process only: at tp 2 the
    JAX calibration fails its assertion, and the port's runner (above) runs
    only a cached plan."""
    from compactfusion_tpu.cache.fast_attn import calibrate_pixart as jcalibrate
    from compactfusion_tpu.config import ParallelConfig as JParallel
    from compactfusion_tpu.models.pixart import pixart_tiny
    from compactfusion_tpu.models.vae import tiny_vae
    from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JCfg
    from compactfusion_tpu_torch.cache.fast_attn import calibrate_pixart
    from compactfusion_tpu_torch.config import ParallelConfig
    from compactfusion_tpu_torch.models.pixart import pixart_tiny as tpixart_tiny
    from compactfusion_tpu_torch.models.vae import tiny_vae as ttiny_vae
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipelineConfig

    size = dict(num_steps=3, height=64, width=64)
    jc = JCfg(model=pixart_tiny(), vae=tiny_vae(), parallel=JParallel(tp_degree=2), **size)
    with pytest.raises(AssertionError, match="single device"):
        jcalibrate({}, jc, jnp.zeros((2, 1, 6, 32)), None, jax.random.PRNGKey(0))
    tc = PixArtPipelineConfig(model=tpixart_tiny(), vae=ttiny_vae(), parallel=ParallelConfig(tp_degree=2), **size)
    with pytest.raises(AssertionError, match="single device"):
        calibrate_pixart({}, tc, torch.zeros((2, 1, 6, 32)), None)


def test_int8_backbone_refused_at_tp_or_pp():
    """``--quantize_backbone_int8`` composes with dp/cfg/SP only: both
    runners refuse a tp or pp layout with an AssertionError."""
    from types import SimpleNamespace

    for argv in (TP2, PP2):
        for mod in (tapi, japi):
            engine, _ = _config(targs if mod is tapi else jargs, argv)
            with pytest.raises(AssertionError, match="tp"):
                mod.xDiTParallel._quantize_backbone_int8(SimpleNamespace(engine_config=engine))


def test_save_on_a_rank_without_an_image(tmp_path):
    """A rank that holds no image (a VAE-tail rank, or a rank other than 0
    with VAE ranks) gets None from the runner: ``save`` writes nothing and
    returns None (the ranks themselves run in tests/test_torch_parallel_vae.py)."""
    runner = port_runner(PIXART)
    runner._generate = lambda *a: None
    assert runner() is None
    assert runner.save(str(tmp_path / "out")) is None
    assert not (tmp_path / "out").exists()


def test_png_writer_against_pil_and_to_uint8_against_jax():
    from compactfusion_tpu.utils.image import to_uint8 as jto_uint8
    from compactfusion_tpu_torch.utils.image import png_bytes

    x = np.random.default_rng(4).random((3, 9, 7, 3)).astype(np.float32) * 1.2 - 0.1
    x[0, 0, 0] = [0.5 / 255, 254.5 / 255, 1.0]
    np.testing.assert_array_equal(to_uint8(x), jto_uint8(x))
    img8 = to_uint8(x)[1]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_bytes(img8)))), img8)
    np.testing.assert_array_equal(read_png(png_bytes(img8)), img8)
    buf = io.BytesIO()
    Image.fromarray(np.tile(np.arange(9, dtype=np.uint8)[:, None, None], (1, 7, 3))).save(buf, format="PNG",
                                                                                          optimize=True)
    # PIL filters its rows; the reader undoes every filter (ConsisID's identity images)
    np.testing.assert_array_equal(read_png(buf.getvalue()), np.asarray(Image.open(io.BytesIO(buf.getvalue()))))
    buf = io.BytesIO()
    Image.fromarray(np.arange(63, dtype=np.uint16).reshape(9, 7) * 1000).save(buf, format="PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):  # 16-bit: not a form the reader takes
        read_png(buf.getvalue())
