"""Step-Video-T2V vs the JAX package on the CPU, fp32, ``stepvideo_tiny``
(2 blocks, dim 64, 4 heads of 16, rope chunks 8/4/4) with spiced
``scale_shift_table`` and ``final_scale_shift``; bound 2e-4 (the fp32
bound of tests/io/test_backbone_parity.py):

* the half-split rope tables and rotation (1e-6); ``init_stepvideo``'s
  tree; ``stepvideo_forward``;
* ``parallel/tp.py::stepvideo_local_params`` against the shards JAX's
  ``stepvideo_param_specs`` puts on each device at tp 2 and 4 (bit for
  bit), and every other family's slicing untouched by the head rule;
* ``io/hf.py::convert_stepvideo`` against JAX's converter on a synthetic
  state dict of ``tests/io/keymaps.py``'s inventory at tiny widths (bit for
  bit, fp32 and bf16; every key read);
* the 3-step pipeline (17 frames at 128 x 128: 3 latent frames of 4 x 4
  tokens, CFG 9 batched, shift 13) against JAX ``pipe._sample``, plain and
  with a per-layer plan on the one-device compressed ring;
* one spawn of 4 gloo processes: TP 2, TP 2 x U2, TP 2 x cfg 2, U2, ring 2
  lossless, fused or not, and ring 2 BINARY, unfused and fused, against
  JAX on a CPU mesh of the same layout (BINARY within a tenth of JAX's
  own codec error, or under TP twice the distance JAX's own run moves when
  its noise moves by 3e-7 relative; EF caches equal on the ring peers);
* ``xDiTParallel`` on ``stepvideo-tiny`` against the JAX runner with its
  weights carried across; ``--quantize_backbone_int8`` leaves the weights
  bf16, as in JAX; the example; the seeded draw.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.models import stepvideo as jsv
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.stepvideo import StepVideoPipeline as JPipe
from compactfusion_tpu.pipelines.stepvideo import StepVideoPipelineConfig as JCfg
from compactfusion_tpu_torch import parallel_api as tapi
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.examples import stepvideo_example
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import stepvideo as tsv
from compactfusion_tpu_torch.parallel.tp import STEPVIDEO_HEADS, shard_params, stepvideo_local_params
from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipeline, StepVideoPipelineConfig
from tests.helpers import rel_err, spice_params
from tests.io import keymaps
from tests.io.test_real_keymaps import TrackingState
from tests.test_torch_api import _config, _f32, _np
from tests.test_torch_cogvideox import _assert_trees_equal

BOUND = 2e-4
SIZE = dict(height=128, width=128, num_frames=17)  # 3 latent frames of 4 x 4 tokens


@pytest.fixture(scope="module")
def models():
    jm = dataclasses.replace(jsv.stepvideo_tiny(), dtype=jnp.float32)
    return jm, spice_params(jsv.init_stepvideo(jax.random.PRNGKey(0), jm))


def _tm():
    return dataclasses.replace(tsv.stepvideo_tiny(), dtype=torch.float32)


@pytest.mark.parametrize("grid", [(3, 4, 4), (2, 3, 5)])
def test_rope_tables_and_rotation_match_jax(grid):
    split = (8, 4, 4)
    want = jsv.stepvideo_rope_tables(*grid, split)
    got = tsv.stepvideo_rope_tables(*grid, split)
    assert len(got) == len(want) == 3
    for (c, s), (jc, js), dax in zip(got, want, split):
        assert c.shape == s.shape == (int(np.prod(grid)), dax) and c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, int(np.prod(grid)), 3, 16)).astype(np.float32)
    jt = [tuple(jnp.asarray(t.numpy()) for t in pair) for pair in got]  # the same tables on both sides
    out = tsv.apply_rope_3d_half(torch.from_numpy(x), got, split).numpy()
    np.testing.assert_allclose(out, np.asarray(jsv.apply_rope_3d_half(jnp.asarray(x), jt, split)), rtol=0, atol=1e-6)
    # a full-dim rotate-half is a different rotation: the chunks matter
    from compactfusion_tpu_torch.models import common as tcm

    cos = torch.cat([c for c, _ in got], -1)
    assert not np.allclose(tcm.apply_rope_half(torch.from_numpy(x), cos, torch.cat([s for _, s in got], -1)).numpy(),
                           out, atol=1e-3)


def test_init_tree_and_forward_match_jax(models):
    jm, jp = models
    own = tsv.init_stepvideo(torch.Generator().manual_seed(0), _tm())
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    tp = params_from_numpy(_np(jp))
    rng = np.random.default_rng(11)
    f, hp, wp = 2, 4, 4
    vid = rng.standard_normal((2, f * hp * wp, 16)).astype(np.float32)
    txt = rng.standard_normal((2, 6, 32)).astype(np.float32)
    t = np.array([212.0, 780.0], np.float32)
    want, _ = jsv.stepvideo_forward(jp, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t), jm,
                                    video_rope=jsv.stepvideo_rope_tables(f, hp, wp, jm.axes_dim))
    got, _ = tsv.stepvideo_forward(tp, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), _tm(),
                                   video_rope=tsv.stepvideo_rope_tables(f, hp, wp, jm.axes_dim))
    assert got.shape == (2, f * hp * wp, 16) and rel_err(got.numpy(), np.asarray(want)) < BOUND


def test_seeded_draw_is_the_jax_tree_in_bf16():
    """Recorded divergence: the seeded weights come from a torch.Generator
    (seed 0) drawn one layer at a time: JAX's tree, shapes and dtypes, with
    other values; each layer of a stack is its own draw, truncated at 2
    standard deviations of 0.02."""
    tm = tsv.stepvideo_tiny()
    own = tsv.init_stepvideo(torch.Generator().manual_seed(0), tm)
    again = tsv.init_stepvideo(torch.Generator().manual_seed(0), tm)
    jp = jsv.init_stepvideo(jax.random.PRNGKey(0), jsv.stepvideo_tiny())
    dtypes = lambda t: jax.tree_util.tree_map(lambda a: str(a.dtype).replace("torch.", ""), t)
    assert dtypes(own) == dtypes(_np(jp))
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)
    w = own["blocks"]["ffn"]["fc1"]["w"].float()
    assert w.abs().max() <= 0.0401 and not torch.equal(w[0], w[1])  # 0.04 rounded to bf16
    assert not np.array_equal(w.numpy(), np.asarray(jp["blocks"]["ffn"]["fc1"]["w"], np.float32))


def _jax_shard(leaf, spec, mesh, index):
    """The shard of ``leaf`` that device ``index`` of ``mesh``'s tp axis holds."""
    arr = jax.device_put(leaf, NamedSharding(mesh, spec))
    dev = mesh.devices.reshape(-1)[index]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shards_match_jax_specs(models, tp):
    jm, jp = models
    mesh = make_mesh(JParallel(tp_degree=tp), devices=jax.devices()[:tp])
    specs = jsv.stepvideo_param_specs(jm)
    leaves, treedef = jax.tree_util.tree_flatten(_np(jp))
    spec_leaves = treedef.flatten_up_to(specs)
    full = params_from_numpy(_np(jp))
    for i in range(tp):
        got = jax.tree_util.tree_leaves(shard_params(full, tp_index=i, tp_size=tp, heads=STEPVIDEO_HEADS))
        assert len(got) == len(leaves)
        for g, leaf, spec in zip(got, leaves, spec_leaves):
            np.testing.assert_array_equal(g.numpy(), _jax_shard(leaf, spec, mesh, i))
    # the heads of one projection: a whole block of H / tp heads per rank
    local = shard_params(full, tp_index=1, tp_size=tp, heads=STEPVIDEO_HEADS)["blocks"]
    assert local["qkv"]["w"].shape == (2, 64, 3, 4 // tp, 16) and local["attn_out"]["b"].shape == (2, 64)
    # without the head rule (every other family) only the ffn splits
    plain = shard_params(full, tp_index=1, tp_size=tp)["blocks"]
    assert plain["qkv"]["w"].shape == (2, 64, 3, 4, 16) and plain["ffn"]["fc1"]["w"].shape == (2, 64, 256 // tp)
    assert stepvideo_local_params(full, None) is full


def _state(rng, dtype_bias):
    """A synthetic Step-Video state dict: the official inventory at tiny
    widths (dim 64, 4 heads of 16, text 32, 16 latent channels), plus the
    optional biases of ``attn1.wqkv`` and ``attn1.wo`` on block 0."""
    shapes = keymaps.stepvideo_keys(depth=2, dim=64, head_dim=16, text_dim=32, in_ch=16)
    state = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if dtype_bias:
        state["transformer_blocks.0.attn1.wqkv.bias"] = rng.standard_normal(3 * 64).astype(np.float32)
        state["transformer_blocks.0.attn1.wo.bias"] = rng.standard_normal(64).astype(np.float32)
    return shapes, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_stepvideo_matches_jax(models, dtype):
    jm = dataclasses.replace(jsv.stepvideo_tiny(), dtype=getattr(jnp, dtype))
    tm = dataclasses.replace(tsv.stepvideo_tiny(), dtype=getattr(torch, dtype))
    for biased in (False, True):
        shapes, state = _state(np.random.default_rng(5 + biased), biased)
        tracked = TrackingState(shapes)
        tracked.update(state)
        got = thf.convert_stepvideo(tracked, tm)
        assert set(shapes) <= tracked.read
        _assert_trees_equal(got, jhf.convert_stepvideo(state, jm), dtype)
    # the converted tiny model runs the JAX forward's numbers
    jm32, tm32 = jsv.stepvideo_tiny(), _tm()
    jm32 = dataclasses.replace(jm32, dtype=jnp.float32)
    _, state = _state(np.random.default_rng(9), True)
    jp = jhf.convert_stepvideo({k: v * 0.05 for k, v in state.items()}, jm32)
    tp = thf.convert_stepvideo({k: v * 0.05 for k, v in state.items()}, tm32)
    rng = np.random.default_rng(2)
    vid = rng.standard_normal((1, 32, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 5, 32)).astype(np.float32)
    t = np.array([500.0], np.float32)
    want, _ = jsv.stepvideo_forward(jp, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t), jm32,
                                    video_rope=jsv.stepvideo_rope_tables(2, 4, 4, jm32.axes_dim))
    got, _ = tsv.stepvideo_forward(tp, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), tm32,
                                   video_rope=tsv.stepvideo_rope_tables(2, 4, 4, tm32.axes_dim))
    assert rel_err(got.numpy(), np.asarray(want)) < BOUND


def _plan(step, layer):
    """Per-layer plan over the 2 blocks: IDENTITY on the first, BINARY on the second."""
    return JType.IDENTITY if layer == 0 else JType.BINARY


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 1, 6, 32)).astype(np.float32), rng.standard_normal((1, 48, 16)).astype(np.float32)


@pytest.mark.parametrize("compact", [None, "plan"])
def test_tiny_pipeline_matches_jax(models, compact):
    jm, jp = models
    ckw = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True)
    jcomp = JCompact(**ckw, compress_func=_plan) if compact else JCompact()
    tcomp = CompactConfig(**ckw, compress_func=lambda s, l: CompressType(_plan(s, l).value)) if compact \
        else CompactConfig()
    jc = JCfg(model=jm, compact=jcomp, num_steps=3, **SIZE)
    jpipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:1]))
    cfg = StepVideoPipelineConfig(model=_tm(), compact=tcomp, num_steps=3, **SIZE)
    pipe = StepVideoPipeline(params_from_numpy(_np(jp)), cfg, "cpu")
    assert cfg.tokens == jc.tokens == 48 and cfg.grid == jc.grid == (3, 4, 4)
    txt, noise = _inputs()
    jlat = np.asarray(jpipe._sample(jp, jnp.asarray(txt), jnp.asarray(noise)))
    lat = pipe(torch.from_numpy(txt), latents=torch.from_numpy(noise), decode=True)  # decode is ignored
    assert lat.shape == jlat.shape == (1, 48, 16) and lat.dtype == torch.float32
    assert rel_err(lat.numpy(), jlat) < BOUND


BINARY = dict(enabled=True, warmup_steps=1, residual=1, error_feedback=True, check_consistency=True,
              compress_type="binary")
RING2 = dict(ring_degree=2)
CONFIGS = [("tp2", dict(tp_degree=2), None), ("tp2 u2", dict(tp_degree=2, ulysses_degree=2), None),
           ("tp2 cfg2", dict(tp_degree=2, cfg_degree=2), None), ("u2", dict(ulysses_degree=2), None),
           ("ring2", RING2, None), ("ring2 fused", dict(RING2, use_fused_ring=True), None),
           ("ring2 binary", RING2, BINARY), ("ring2 binary fused", dict(RING2, use_fused_ring=True), BINARY),
           ("tp2 ring2 binary", dict(RING2, tp_degree=2), BINARY)]


@pytest.fixture(scope="module")
def spawned(models):
    from compactfusion_tpu_torch.parallel import mesh as tmesh
    from tests.test_torch_rank_fns import stepvideo_latents

    return tmesh.spawn_local(stepvideo_latents, 4, "gloo", CONFIGS, _np(models[1]), _inputs(), threads=1,
                             timeout=300)


@pytest.fixture(scope="module")
def jax_latents(models):
    """JAX's final latents at a layout, lossless or BINARY, cached."""
    jm, jp = models

    @functools.lru_cache(maxsize=None)
    def run(par_items=(), compact=False, jitter=0.0):
        """``jitter``: the noise scaled by 1 + jitter x a fixed normal draw."""
        jc = JCfg(model=jm, parallel=JParallel(**dict(par_items)), num_steps=3, compact=JCompact(
            **dict(BINARY, compress_type=JType.BINARY)) if compact else JCompact(), **SIZE)
        pipe = JPipe(jp, jc, make_mesh(jc.parallel, devices=jax.devices()[:jc.parallel.world_size]))
        txt, noise = _inputs()
        noise = noise * (1 + jitter * np.random.default_rng(0).standard_normal(noise.shape).astype(np.float32))
        return np.asarray(pipe._sample(jp, jnp.asarray(txt), jnp.asarray(noise)))

    return run


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[0])
def test_stepvideo_across_ranks_matches_jax(spawned, jax_latents, config):
    name, par, compact = config
    world = int(np.prod([v for k, v in par.items() if k.endswith("degree")]))
    for rank, res in enumerate(spawned):
        if rank >= world:
            assert res[name] is None
            continue
        lat, dev = res[name]
        assert lat.shape == (1, 48, 16)
        if compact is None:
            # the layout's own JAX run where TP is in it (the sums split
            # over the tp axis), else JAX's one device
            ref = jax_latents(tuple(par.items())) if "tp_degree" in par else jax_latents()
            assert rel_err(lat, ref) < BOUND, rank
        else:
            layout = tuple((k, v) for k, v in par.items() if k != "use_fused_ring")
            ref, lossless = jax_latents(layout, True), jax_latents(layout)
            jax_codec_err = rel_err(ref, lossless)
            assert jax_codec_err > 0 and rel_err(lat, lossless) > 0
            # a BINARY sign at a near-zero delta flips with the sum order:
            # under TP the K/V projections' inputs carry the all-reduce's
            # (lossless runs differ by ~4e-7), and JAX's own run moves by
            # 1.3e-5 when its noise moves by 3e-7 relative
            jax_jitter = rel_err(jax_latents(layout, True, 3e-7), ref)
            assert rel_err(lat, ref) < max(0.1 * jax_codec_err, 2 * jax_jitter), rank
            assert dev == 0.0, rank
        np.testing.assert_array_equal(lat, spawned[0][name][0])


TINY = ["--model", "stepvideo-tiny", "--height", "128", "--width", "128", "--num_frames", "17",
        "--num_inference_steps", "2", "--max_sequence_length", "8", "--prompt", "a dance", "--seed", "5"]


def _jax_runner(argv):
    """The JAX runner from a command line, moved to fp32 (backbone, T5), and
    its weights as numpy trees."""
    from compactfusion_tpu import args as jargs
    from compactfusion_tpu import parallel_api as japi

    jr = japi.xDiTParallel(*_config(jargs, argv))
    pcfg, pipe = jr.pipeline_config, jr.pipeline
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, dtype=jnp.float32))
    params = _f32(pipe.params)
    jr.pipeline, jr.pipeline_config = JPipe(params, cfg, pipe.mesh), cfg
    enc = jr.prompt_encoder
    enc.t5.params = _f32(enc.t5.params)
    enc.t5.cfg = dataclasses.replace(enc.t5.cfg, dtype=jnp.float32)
    enc._jit_t5, enc._jit_clip = None, {}
    return jr, {"params": _np(params), "t5": _np(enc.t5.params)}


def _port_runner(argv, weights):
    from compactfusion_tpu_torch import args as targs

    tr = tapi.xDiTParallel(*_config(targs, argv), device="cpu")
    cfg = dataclasses.replace(tr.pipeline_config, model=dataclasses.replace(tr.pipeline_config.model,
                                                                            dtype=torch.float32))
    tr.pipeline = StepVideoPipeline(params_from_numpy(weights["params"], dtype=torch.float32), cfg, tr.device)
    tr.pipeline_config = cfg
    t5 = tr.prompt_encoder.t5
    t5.params = params_from_numpy(weights["t5"], dtype=torch.float32)
    t5.cfg = dataclasses.replace(t5.cfg, dtype=torch.float32)
    return tr


def test_tiny_runner_matches_jax(tmp_path, monkeypatch):
    jr, weights = _jax_runner(TINY)
    tr = _port_runner(TINY, weights)
    assert tr.family == jr.family == "stepvideo"
    cfg, inp = jr.pipeline_config, jr.input_config
    noise = np.array(jax.random.normal(jax.random.PRNGKey(inp.seed), (1, cfg.tokens, 16), jnp.float32))
    jlat = np.asarray(jr.pipeline._sample(jr.pipeline.params,
                                          jr.prompt_encoder.encode_for_video(["a dance"], [""], max_length=8),
                                          jnp.asarray(noise)))
    lat = tr(latents=torch.from_numpy(noise))
    assert lat.shape == jlat.shape == (1, 48, 16) and rel_err(lat.numpy(), jlat) < BOUND
    # the JAX runner's own noise path gives latents of the same shape
    assert np.asarray(jr()).shape == (1, 48, 16)
    monkeypatch.chdir(tmp_path)
    assert tr.save("out", out=lat).endswith("out/cftpu_rank0.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "cftpu_rank0.npy"), lat.numpy())
    monkeypatch.setattr(stepvideo_example, "xDiTParallel", functools.partial(tapi.xDiTParallel, device="cpu"))
    out, saved = stepvideo_example.main(TINY)
    assert out.shape == (1, 48, 16) and saved == "results/stepvideo_rank0.npy"


def test_registry_build_and_int8_flag(monkeypatch):
    """The registry builds Step-Video on the device asked for (seeded
    weights, no VAE); ``--quantize_backbone_int8`` asserts tp = pp = 1, warns
    and leaves the weights bf16, as the JAX runner does; the family's
    pipeline defaults are the published ones."""
    from compactfusion_tpu_torch import args as targs

    engine, inp = _config(targs, TINY + ["--quantize_backbone_int8"])
    warned = []
    monkeypatch.setattr(tapi.logger, "warning", lambda msg, *a: warned.append(msg % a))
    tr = tapi.xDiTParallel(engine, inp, device="cpu")
    assert warned == ["quantize_backbone_int8: no int8 key map for family stepvideo; weights stay bf16"]
    assert tr.pipeline.params["blocks"]["qkv"]["w"].dtype == torch.bfloat16
    assert tr.pipeline.device.type == "cpu" and tr.pipeline.params["blocks"]["qkv"]["w"].device.type == "cpu"
    engine, inp = _config(targs, TINY + ["--quantize_backbone_int8", "--tensor_parallel_degree", "2"])
    runner = object.__new__(tapi.xDiTParallel)
    runner.engine_config, runner.family = engine, "stepvideo"
    with pytest.raises(AssertionError, match="not tp/pp"):
        runner._quantize_backbone_int8()
    defaults = StepVideoPipelineConfig(model=tsv.stepvideo_t2v())
    assert (defaults.grid, defaults.tokens, defaults.num_steps, defaults.guidance_scale, defaults.shift) == \
        ((36, 17, 31), 18972, 50, 9.0, 13.0)
    with pytest.raises(ValueError, match="ulysses_degree .2. \\* tp_degree .5."):
        StepVideoPipelineConfig(model=tsv.stepvideo_t2v(), parallel=dataclasses.replace(
            engine.parallel_config, tp_degree=5, ulysses_degree=2))


def test_service_serves_latents(monkeypatch):
    """The HTTP service serves Step-Video as the other video families: one
    ``.npy`` of the final latents (1, tokens, 64) a request."""
    import base64
    import io
    import threading
    from http.server import ThreadingHTTPServer

    from compactfusion_tpu_torch import args as targs
    from compactfusion_tpu_torch.entrypoints.launch import Engine, make_handler
    from tests.test_torch_api import _http

    parser = targs.FlexibleArgumentParser()
    targs.xFuserArgs.add_cli_args(parser)
    engine = Engine(targs.xFuserArgs.from_cli_args(parser.parse_args(TINY)), serve_batch=1, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        code, r = _http(f"http://127.0.0.1:{server.server_address[1]}/generate", {"prompt": "a dance", "seed": 2})
        assert code == 200 and r["media_type"] == "application/x-npy" and r["shape"] == [1, 48, 16]
        lat = np.load(io.BytesIO(base64.b64decode(r["output"])))
        assert lat.shape == (1, 48, 16) and np.isfinite(lat).all() and lat.std() > 0
    finally:
        server.shutdown()
        engine.close()
