"""The rank halves of the port's multi-process parity tests.

``parallel.mesh.spawn_local`` starts every rank in a new process, which
imports the module of the function it runs.  The functions live here,
apart from the test files, so that a rank imports torch and the port and
not JAX.  Each takes its cases and inputs from the test in the parent
process and returns plain numpy data.  This module holds no test.
"""

import torch

from compactfusion_tpu_torch.compact import codecs, lowrank
from compactfusion_tpu_torch.compact import ring as tring
from compactfusion_tpu_torch.compact.engine import check_consistency
from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.parallel.ring import ring_attention, ring_shift
from compactfusion_tpu_torch.parallel.usp import usp_attention


def _ring_meshes():
    """Ring 2 on a dp 2 x ring 2 mesh, and ring 4 (every rank builds both,
    in this order)."""
    return {2: tmesh.make_mesh(ParallelConfig(dp_degree=2, ring_degree=2)),
            4: tmesh.make_mesh(ParallelConfig(ring_degree=4))}


def _local(arrays, mesh, s_local):
    i = mesh.axis_index("ring")
    return tuple(torch.from_numpy(a[:, i * s_local:(i + 1) * s_local]) for a in arrays)


def mesh_checks(rank, world, layouts):
    """Per layout: this rank's coordinates and lines, a ring shift of a
    mixed-dtype payload and its byte count, a gather and a sum over the ring,
    and the consistency oracle on identical and on rank-dependent caches."""
    res = {}
    for layout in layouts:
        m = tmesh.make_mesh(ParallelConfig(**layout))
        r = {"coords": dict(m.coords), "lines": dict(m.lines)}
        payload = (torch.full((2, 3), rank, dtype=torch.uint8),
                   torch.full((5,), rank + 0.5, dtype=torch.bfloat16),
                   torch.full((1, 2), rank * 10.0, dtype=torch.float32))
        ring_shift.nbytes = 0
        got = ring_shift(payload, m, "ring")
        r["shift"] = [t.float().flatten().tolist() for t in got]
        r["shift_dtypes"] = [str(t.dtype) for t in got]
        r["shift_bytes"] = ring_shift.nbytes
        r["gather"] = [t.item() for t in m.all_gather(torch.tensor([float(rank)]), "ring")]
        r["sum"] = m.all_reduce_sum(torch.tensor([float(rank)]), "ring").item()
        st = tring.init_ring_state(m.axis_size("ring"), 4, 8, torch.float32, 1)
        r["dev_same"] = check_consistency(st.k, m, "ring").item()
        st.k.base[0, 0, 0] = float(rank)
        r["dev_diff"] = check_consistency(st.k, m, "ring").item()
        res[tuple(sorted(layout.items()))] = r
    return res


def ring_outputs(rank, world, cases, inputs, s_local):
    """Per case (ring, joint strategy, fused, causal, with a joint query):
    this rank's output shard and the bytes its ring shifts sent."""
    meshes = _ring_meshes()
    out, nbytes = {}, {}
    for case in cases:
        ring, joint, fused, causal, with_q = case
        m = meshes[ring]
        q, k, v = _local(inputs[ring][:3], m, s_local)
        jq, jk, jv = (torch.from_numpy(a) for a in inputs[ring][3:])
        kw = dict(joint_k=None if joint == "none" else jk, joint_v=None if joint == "none" else jv,
                  joint_strategy=joint)
        ring_shift.nbytes = 0
        if with_q:
            o = usp_attention(q, k, v, mesh=m, joint_q=jq, fused_ring=fused, **kw)
        else:
            o = ring_attention(q, k, v, mesh=m, causal=causal, fused=fused, **kw)
        out[case] = o.numpy()
        nbytes[case] = ring_shift.nbytes
    return out, nbytes


def _stack_leaves(state):
    """The EF stacks as fp32 numpy copies (they update in place): base, or
    (codes, scale, min) per entry."""
    return [t.float().numpy().copy() for entry in (state.k.base, state.v.base)
            for t in (entry if isinstance(entry, codecs.Int8Payload) else (entry,))]


def compact_ring_outputs(rank, world, cases, inputs, init_q, s_local, channels):
    """Per case (codec, comp_rank, batch, int8 bases, ring) and route
    (unfused, fused): this rank's output shard and stacks after every
    drifting step.  ``init_q`` maps (n, rank) to the JAX start basis."""
    lowrank._init_q = lambda n, r, device=None: init_q[(n, r)]
    meshes = _ring_meshes()
    res = {}
    for case in cases:
        codec, comp_rank, b, quantized, ring = case
        m = meshes[ring]
        cfg = CompactConfig(enabled=True, compress_type=CompressType(codec), comp_rank=comp_rank,
                            residual=1, error_feedback=True, warmup_steps=0,
                            quantized_cache=quantized)
        for fused in (False, True):
            state = tring.init_ring_state(ring, b * s_local, channels, torch.float32, 1, quantized)
            per_step = []
            for step in inputs[case]:
                q, k, v = _local(step, m, s_local)
                out, state = tring.compact_ring_attention(q, k, v, state, cfg=cfg,
                                                          method=cfg.compress_type, mesh=m,
                                                          fused=fused)
                per_step.append((out.numpy(), _stack_leaves(state)))
            res[case + (fused,)] = per_step
    return res


def pipeline_latents(rank, world, configs, params, vae_params, inputs):
    """Per configuration (name, ParallelConfig kwargs, CompactConfig kwargs
    or None, batch): the tiny fp32 PixArt pipeline's final latents on this
    rank (every rank gets the whole latents) from ``inputs[batch]`` = (text,
    mask, noise), and the largest EF cache deviation across the ring that
    the consistency check saw."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tparams, tvae_params = params_from_numpy(params), params_from_numpy(vae_params)
    res = {}
    for name, par, compact, batch in configs:
        parallel = ParallelConfig(**par)
        ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
        cfg = PixArtPipelineConfig(model=tm, vae=tv, parallel=parallel, num_steps=4, height=64,
                                   width=64, compact=CompactConfig(**ckw))
        pipe = PixArtPipeline(tparams, tvae_params, cfg, "cpu", mesh=tmesh.make_mesh(parallel))
        text, mask, noise = (torch.from_numpy(a) for a in inputs[batch])
        tring.max_consistency_dev = 0.0
        lat = pipe(text, mask, latents=noise, decode=False)
        res[name] = (lat.numpy(), tring.max_consistency_dev)
    return res


def flux_pipeline_latents(rank, world, configs, params, vae_params, inputs):
    """Per configuration (name, ParallelConfig kwargs, CompactConfig kwargs
    or None): the tiny fp32 FLUX pipeline's final latents on this rank from
    ``inputs`` = (txt, pooled, noise) and the largest EF cache deviation
    across the ring; under "cache skips", FBCache at threshold 1e6 on a
    ring of 2 (4 steps, the probe summed over the ring): its skipped steps
    and latents."""
    import dataclasses

    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import flux as tflux
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    tm = dataclasses.replace(tflux.flux_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tparams, tvae_params = params_from_numpy(params), params_from_numpy(vae_params)
    txt, pooled, noise = (torch.from_numpy(a) for a in inputs)
    res = {}
    for name, par, compact in configs:
        parallel = ParallelConfig(**par)
        ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
        cfg = FluxPipelineConfig(model=tm, vae=tv, parallel=parallel, num_steps=4, height=64, width=128,
                                 compact=CompactConfig(**ckw))
        pipe = FluxPipeline(tparams, tvae_params, cfg, "cpu", mesh=tmesh.make_mesh(parallel))
        tring.max_consistency_dev = 0.0
        lat = pipe(txt, pooled, latents=noise, decode=False)
        res[name] = (lat.numpy(), tring.max_consistency_dev)
    parallel = ParallelConfig(ring_degree=2)
    cached = FluxPipelineConfig(model=tm, vae=tv, parallel=parallel, num_steps=4, height=64, width=128,
                                cache=CacheAccelConfig(mode="fbcache", threshold=1e6))
    pipe = FluxPipeline(tparams, tvae_params, cached, "cpu", mesh=tmesh.make_mesh(parallel))
    lat = pipe(txt, pooled, latents=noise, decode=False)
    res["cache skips"] = (pipe.last_skips, lat.numpy())
    return res


def cogvideox_pipeline_latents(rank, world, configs, models, inputs):
    """Per configuration (name, model form, ParallelConfig kwargs,
    CompactConfig kwargs or None): the tiny fp32 CogVideoX pipeline's final
    latents on this rank (32 x 48, 9 frames: 18 video tokens, 4 steps,
    guidance 6) from ``inputs`` = (txt, noise), and the largest EF cache
    deviation across the ring.  ``models``: {form: (use_rotary, params)}."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import cogvideox as tcog
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig

    built = {form: (dataclasses.replace(tcog.cogvideox_tiny(), use_rotary=rotary, dtype=torch.float32),
                    params_from_numpy(params)) for form, (rotary, params) in models.items()}
    txt, noise = (torch.from_numpy(a) for a in inputs)
    res = {}
    for name, form, par, compact in configs:
        tm, tparams = built[form]
        parallel = ParallelConfig(**par)
        ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
        cfg = CogVideoXPipelineConfig(model=tm, parallel=parallel, num_steps=4, height=32, width=48, num_frames=9,
                                      compact=CompactConfig(**ckw))
        pipe = CogVideoXPipeline(tparams, None, cfg, "cpu", mesh=tmesh.make_mesh(parallel))
        tring.max_consistency_dev = 0.0
        lat = pipe(txt, latents=noise, decode=False)
        res[name] = (lat.numpy(), tring.max_consistency_dev)
    return res


def _sp_meshes():
    """Ulysses 2 x ring 2 and Ulysses 4 (every rank builds both, in this
    order)."""
    return {"u2r2": tmesh.make_mesh(ParallelConfig(ulysses_degree=2, ring_degree=2)),
            "u4": tmesh.make_mesh(ParallelConfig(ulysses_degree=4))}


def _sp_local(arrays, mesh):
    """This rank's (ring, ulysses) token shard of each (B, S, ...) array."""
    from compactfusion_tpu_torch.pipelines.base import slice_local_tokens

    p = mesh.parallel
    return tuple(slice_local_tokens(torch.from_numpy(a), mesh, p.ulysses_degree, p.ring_degree, dim=1)
                 .contiguous() for a in arrays)


def ulysses_outputs(rank, world, prim, attn_cases, attn_inputs, compact_steps):
    """Per layout ("u2r2", "u4"): the three all-to-all primitives on this
    rank's shard of ``prim`` = (x, joint) and the all-to-all bytes; per
    ``attn_cases`` entry (layout, joint strategy, fused, with a joint
    query): ``usp_attention``'s output on this rank's shard of
    ``attn_inputs``; then ``compact_usp_attention`` BINARY at U2 x R2 over
    ``compact_steps``, unfused and fused: per step the output, the EF stacks
    and their largest deviation across the ring."""
    from compactfusion_tpu_torch.parallel import ulysses as uly

    meshes = _sp_meshes()
    res = {"prim": {}, "attn": {}, "compact": {}}
    for name, m in meshes.items():
        u = m.parallel.ulysses_degree
        (x,) = _sp_local(prim[:1], m)
        tmesh.Mesh.all_to_all.nbytes = 0
        a = uly.scatter_heads_gather_seq(x, m)
        nbytes = tmesh.Mesh.all_to_all.nbytes
        b = uly.scatter_seq_gather_heads(a, m)
        j = uly.slice_joint_heads(torch.from_numpy(prim[1]), m, u)
        res["prim"][name] = (a.numpy(), b.numpy(), j.numpy(), nbytes)
    for case in attn_cases:
        name, joint, fused, with_q = case
        m = meshes[name]
        q, k, v = _sp_local(attn_inputs[:3], m)
        jq, jk, jv = (torch.from_numpy(a) for a in attn_inputs[3:])
        kw = dict(joint_k=None if joint == "none" else jk, joint_v=None if joint == "none" else jv,
                  joint_strategy=joint)
        o = usp_attention(q, k, v, mesh=m, ulysses_size=m.parallel.ulysses_degree,
                          joint_q=jq if with_q else None, fused_ring=fused, **kw)
        res["attn"][case] = o.numpy()
    m = meshes["u2r2"]
    cfg = CompactConfig(enabled=True, compress_type=CompressType.BINARY, residual=1, error_feedback=True,
                        warmup_steps=0)
    for fused in (False, True):
        per_step, state = [], None
        for step in compact_steps:
            q, k, v = _sp_local(step, m)
            b, s, h, d = k.shape
            if state is None:
                state = tring.init_ring_state(2, b * s * 2, (h // 2) * d, torch.float32, 1)
            out, state = tring.compact_usp_attention(q, k, v, state, cfg=cfg, method=cfg.compress_type,
                                                     mesh=m, ulysses_size=2, fused=fused)
            dev = max(check_consistency(state.k, m, "ring").item(), check_consistency(state.v, m, "ring").item())
            per_step.append((out.numpy(), _stack_leaves(state), dev))
        res["compact"][fused] = per_step
    return res


def patch_outputs(rank, world, runs, gather_runs):
    """On a ring-4 mesh.  Per run (name, mode, CompactConfig kwargs or None,
    steps of global (q, k, v), each step's method): ``PatchParallelAttn``'s
    output on this rank's shard and its state leaves after every step.  Per
    gather run (name, CompactConfig kwargs, steps of global (N * W, C)
    inputs): ``compact_all_gather``'s reconstructions and stacks after every
    step, and the bytes it gathered."""
    from compactfusion_tpu_torch.compact.allgather import compact_all_gather
    from compactfusion_tpu_torch.models.common import layer_of
    from compactfusion_tpu_torch.parallel.patch import PatchParallelAttn

    m = tmesh.make_mesh(ParallelConfig(ring_degree=4))
    my = m.axis_index("ring")
    res = {}
    for name, mode, ckw, steps, methods in runs:
        cfg = None if ckw is None else CompactConfig(**dict(ckw, compress_type=CompressType(ckw["compress_type"])))
        state, per_step = None, []
        for (q, k, v), method in zip(steps, methods):
            ql, kl, vl = _sp_local((q, k, v), m)
            impl = PatchParallelAttn(cfg=cfg, method=None if method is None else CompressType(method),
                                     mode=mode, mesh=m)
            if state is None:
                b, s, h, d = kl.shape
                state = impl.init_state(1, b, s, h, d, torch.float32)
            out, _ = impl(ql, kl, vl, layer_of(state, 0))
            leaves = [t.float().numpy().copy() for t in _leaves_of(state)]
            per_step.append((out.numpy(), leaves))
        res[name] = per_step
    for name, ckw, steps in gather_runs:
        cfg = CompactConfig(**dict(ckw, compress_type=CompressType(ckw["compress_type"])))
        state, per_step = None, []
        for x in steps:
            n = x.shape[0] // 4
            xl = torch.from_numpy(x[my * n:(my + 1) * n])
            if state is None:
                st = tring.init_ring_state(4, n, x.shape[1], torch.float32, cfg.residual, cfg.quantized_cache)
                state = st.k
            tmesh.Mesh.all_gather_tree.nbytes = 0
            got, state = compact_all_gather(xl, state, cfg=cfg, method=cfg.compress_type, mesh=m)
            leaves = [t.float().numpy().copy() for t in _leaves_of(state)]
            per_step.append((got.numpy(), leaves, tmesh.Mesh.all_gather_tree.nbytes))
        res[name] = per_step
    return res


def _leaves_of(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree if part is not None for leaf in _leaves_of(part)]


def sp_pipeline_latents(rank, world, jobs):
    """Per family ("pixart": the tiny fp32 PixArt at 64 x 64, inputs (text,
    mask, noise) by batch; "flux": the tiny fp32 FLUX at 64 x 128, inputs
    (txt, pooled, noise)) in ``jobs`` = {family: (configs, params,
    vae_params, inputs)}, per configuration (name, ParallelConfig kwargs,
    CompactConfig kwargs or None, CacheAccelConfig kwargs or None, batch):
    the final latents on this rank, the largest EF cache deviation across
    the ring and the skipped steps (None without a cache)."""
    import dataclasses

    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import flux as tflux
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    families = {"pixart": (PixArtPipeline, PixArtPipelineConfig, tpix.pixart_tiny(), dict(height=64, width=64)),
                "flux": (FluxPipeline, FluxPipelineConfig, tflux.flux_tiny(), dict(height=64, width=128))}
    res = {}
    for family, (configs, params, vae_params, inputs) in jobs.items():
        pipe_cls, cfg_cls, tm, size = families[family]
        tm = dataclasses.replace(tm, dtype=torch.float32)
        tparams, tvae_params = params_from_numpy(params), params_from_numpy(vae_params)
        for name, par, compact, cache, batch in configs:
            parallel = ParallelConfig(**par)
            ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
            cfg = cfg_cls(model=tm, vae=tv, parallel=parallel, num_steps=4, compact=CompactConfig(**ckw),
                          cache=CacheAccelConfig(**(cache or {})), **size)
            pipe = pipe_cls(tparams, tvae_params, cfg, "cpu", mesh=tmesh.make_mesh(parallel))
            *args, noise = (torch.from_numpy(a) for a in (inputs[batch] if family == "pixart" else inputs))
            tring.max_consistency_dev = 0.0
            lat = pipe(*args, latents=noise, decode=False)
            res[family, name] = (lat.numpy(), tring.max_consistency_dev, pipe.last_skips)
    return res


def carry_weights(runner, weights):
    """Replace every weight of an ``xDiTParallel`` runner by the given numpy
    trees ("params", "vae", "t5" and, for FLUX, "clip_l") with the backbone
    and VAE configs in fp32: the runner then computes what a JAX runner
    with the same weights computes in fp32."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy

    f32 = torch.float32
    pcfg = runner.pipeline_config
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, dtype=f32),
                              vae=dataclasses.replace(pcfg.vae, dtype=f32))
    runner.pipeline = type(runner.pipeline)(params_from_numpy(weights["params"], dtype=f32),
                                            params_from_numpy(weights["vae"], dtype=f32), cfg, runner.device,
                                            mesh=runner.pipeline.mesh, vae_mesh=runner.pipeline.vae_mesh)
    runner.pipeline_config = cfg
    enc = runner.prompt_encoder
    for name in ("t5", "clip_l"):
        bundle = getattr(enc, name)
        if bundle is not None:
            bundle.params = params_from_numpy(weights[name], dtype=f32)
            bundle.cfg = dataclasses.replace(bundle.cfg, dtype=f32)
    return runner


def port_runner(argv, weights=None, device="cpu"):
    """The port's ``xDiTParallel`` from a command line, on ``device``; with
    ``weights``, :func:`carry_weights` on it.  A DiTFastAttn switch then
    applies after the weights are in, to the runner's own (on a tp rank:
    already cut) pipeline, as it applies to seeded weights."""
    import dataclasses

    from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    parser = FlexibleArgumentParser()
    xFuserArgs.add_cli_args(parser)
    engine, inp = xFuserArgs.from_cli_args(parser.parse_args(argv)).create_config()
    fast = engine.fast_attn_config
    if weights is not None and fast.use_fast_attn:
        engine = dataclasses.replace(engine, fast_attn_config=dataclasses.replace(fast, use_fast_attn=False))
    runner = xDiTParallel(engine, inp, device=device)
    if weights is None:
        return runner
    carry_weights(runner, weights)
    if fast.use_fast_attn:
        runner._apply_fast_attn(fast)
    return runner


def runner_latents(rank, world, runs, weights, noise, cwd=None):
    """Per run (name, argv): :func:`port_runner` with ``weights`` on this
    rank's CPU, run on ``noise``, from the directory ``cwd`` when given; the
    final latents, the bytes this rank's ring shifts sent and the warnings
    the port logged while the runner was built."""
    import logging
    import os

    class Collect(logging.Handler):
        messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    if cwd is not None:
        os.chdir(cwd)
    handler = Collect(logging.WARNING)
    logging.getLogger("compactfusion_tpu_torch").addHandler(handler)
    out = {}
    for name, argv in runs:
        handler.messages = []
        runner = port_runner(argv, weights)
        ring_shift.nbytes = 0
        lat = runner(latents=torch.from_numpy(noise), decode=False)
        out[name] = {"latents": lat.numpy(), "wire_bytes": ring_shift.nbytes, "warnings": handler.messages}
    return out


def nonfinite_consistency(rank, world):
    """On a ring of 2: the consistency oracle and ``consistency_assert`` on
    caches equal on both ranks, clean ("clean"), with one NaN slot ("nan")
    and with one +Inf slot ("inf"): the deviation, whether the assert
    raised, and the bytes the oracle gathered."""
    m = tmesh.make_mesh(ParallelConfig(ring_degree=2))
    res = {}
    for case, value in (("clean", None), ("nan", float("nan")), ("inf", float("inf"))):
        st = tring.init_ring_state(2, 4, 8, torch.float32, 1)
        if value is not None:
            st.k.base[1, 2, 3] = value
        dev = check_consistency(st.k, m, "ring").item()
        try:
            tring.consistency_assert(st, m, "ring")
            raised = False
        except AssertionError:
            raised = True
        res[case] = (dev, raised)
    return res


def _join_groups(parallel):
    """A rank that runs no part of ``parallel`` still takes part in
    creating its process groups (``new_group`` is collective)."""
    tmesh.make_mesh(parallel)
    tmesh.make_vae_mesh(parallel)


def _family(family, model_kw):
    """(pipeline class, config class, fp32 model, size kwargs) of a tiny family."""
    import dataclasses

    from compactfusion_tpu_torch.models import cogvideox as tcog
    from compactfusion_tpu_torch.models import flux as tflux
    from compactfusion_tpu_torch.models import hunyuandit as thy
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import sd3 as tsd3
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
    from compactfusion_tpu_torch.pipelines.hunyuandit import HunyuanDiTPipeline, HunyuanDiTPipelineConfig
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
    from compactfusion_tpu_torch.pipelines.sd3 import SD3Pipeline, SD3PipelineConfig

    pipe_cls, cfg_cls, model, size = {
        "pixart": (PixArtPipeline, PixArtPipelineConfig, tpix.pixart_tiny(), dict(height=64, width=64)),
        "flux": (FluxPipeline, FluxPipelineConfig, tflux.flux_tiny(), dict(height=64, width=128)),
        "cogvideox": (CogVideoXPipeline, CogVideoXPipelineConfig, tcog.cogvideox_tiny(),
                      dict(height=32, width=48, num_frames=9)),
        "sd3": (SD3Pipeline, SD3PipelineConfig, tsd3.sd3_tiny(), dict(height=64, width=128)),
        "hunyuandit": (HunyuanDiTPipeline, HunyuanDiTPipelineConfig, thy.hunyuandit_tiny(),
                       dict(height=64, width=128)),
    }[family]
    return pipe_cls, cfg_cls, dataclasses.replace(model, dtype=torch.float32, **model_kw), size


def parallel_pipeline_latents(rank, world, jobs):
    """Per family ("pixart" and "hunyuandit": inputs (text, mask, noise);
    "flux": (txt, pooled, noise); "sd3": (txt, pooled, noise) with txt and
    pooled [cond, uncond]; "cogvideox": (txt, noise)) in ``jobs`` = {family:
    (model overrides, configurations, params, vae_params, inputs)}, per
    configuration (name, ParallelConfig kwargs, CompactConfig kwargs or
    None, pipeline-config kwargs): the tiny fp32 pipeline's final latents
    on this rank and the largest EF cache deviation across the ring, or
    None on a rank the configuration leaves idle."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import vae as tvae

    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    res = {}
    for family, (model_kw, configs, params, vae_params, inputs) in jobs.items():
        pipe_cls, cfg_cls, tm, size = _family(family, model_kw)
        tparams = params_from_numpy(params)
        tvae_params = None if vae_params is None else params_from_numpy(vae_params)
        *args, noise = (torch.from_numpy(a) for a in inputs)
        for name, par, compact, extra in configs:
            parallel = ParallelConfig(**par)
            mesh = tmesh.make_mesh(parallel)
            if mesh is None:
                res[family, name] = None
                continue
            ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
            kw = dict(size, **dict(dict(num_steps=4), **extra))
            if family != "cogvideox":
                kw["vae"] = tv
            cfg = cfg_cls(model=tm, parallel=parallel, compact=CompactConfig(**ckw), **kw)
            pipe = pipe_cls(tparams, tvae_params, cfg, "cpu", mesh=mesh)
            tring.max_consistency_dev = 0.0
            lat = pipe(*args, latents=noise, decode=False)
            res[family, name] = (lat.numpy(), tring.max_consistency_dev)
    return res


def tp_ffn_outputs(rank, world, params, x):
    """The tiny ffn (``params``, numpy) on ``x`` at tp 4: this rank's share
    (``parallel/tp.py``) summed over the tp axis."""
    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import common as cm
    from compactfusion_tpu_torch.parallel.tp import local_params

    m = tmesh.make_mesh(ParallelConfig(tp_degree=4))
    local = local_params({"blocks": {"ffn": params_from_numpy(params)}}, m)["blocks"]["ffn"]
    return cm.ffn(local, torch.from_numpy(x), tp_axis="tp", mesh=m).numpy()


def vae_band_outputs(rank, world, cases, params, lat):
    """Per case (bands n, "fp32" or "bf16"): the tiny VAE's banded decode
    of ``lat`` over a ring of n ranks (``parallel/vae.py``), this rank's
    band of the image (None on an idle rank)."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.parallel.vae import parallel_vae_decode

    res = {}
    for n, dtype in cases:
        dt = torch.float32 if dtype == "fp32" else torch.bfloat16
        cfg = dataclasses.replace(tvae.tiny_vae(), dtype=dt)
        m = tmesh.make_mesh(ParallelConfig(ring_degree=n))
        if m is None:
            res[n, dtype] = None
            continue
        hb = lat.shape[1] // n
        band = torch.from_numpy(lat[:, rank * hb:(rank + 1) * hb])
        res[n, dtype] = parallel_vae_decode(params_from_numpy(params, dtype=dt), band, cfg, m, "ring").float().numpy()
    return res


def runner_images(rank, world, runs):
    """Per run (name, argv, noise): the port's ``xDiTParallel`` on this
    rank's CPU with its own seeded weights, run on ``noise`` and decoded: the images
    (None where the rank holds none), and whether ``save`` (which runs the
    request again) returned a path and the files it wrote.
    A rank past the run's mesh and VAE tail only joins its groups."""
    import os
    import tempfile

    from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs

    out = {}
    for name, argv, noise in runs:
        parser = FlexibleArgumentParser()
        xFuserArgs.add_cli_args(parser)
        engine, _ = xFuserArgs.from_cli_args(parser.parse_args(argv)).create_config()
        par = engine.parallel_config
        if rank >= par.world_size + par.vae_parallel_size:
            _join_groups(par)
            out[name] = None
            continue
        runner = port_runner(argv)
        img = runner(latents=torch.from_numpy(noise))
        with tempfile.TemporaryDirectory() as d:
            saved = runner.save(d)  # every rank runs the request again
            files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        out[name] = (None if img is None else img.float().numpy(), saved is not None, files)
    return out


def tp_outputs(rank, world, ffn_args, jobs):
    """:func:`tp_ffn_outputs` on the first 4 ranks, then
    :func:`parallel_pipeline_latents` of ``jobs`` (one spawn for both)."""
    ffn = tp_ffn_outputs(rank, world, *ffn_args) if rank < 4 else None
    if rank >= 4:
        _join_groups(ParallelConfig(tp_degree=4))
    return ffn, parallel_pipeline_latents(rank, world, jobs)


def vae_outputs(rank, world, band_args, runs):
    """:func:`vae_band_outputs` of ``band_args``, then :func:`runner_images`
    of ``runs`` (one spawn for both)."""
    return vae_band_outputs(rank, world, *band_args), runner_images(rank, world, runs)


def stats_ring_outputs(rank, world, steps, collect_dir, s_local):
    """On a ring of 2: ``compact_ring_attention`` over ``steps`` (a WARMUP
    step, then BINARY; residual 1 + EF, ``log_stats`` on) with the collector
    writing to ``collect_dir``, the fused route asked for (collection keeps
    it off); returns this rank's StatsLogger records and spectra, and
    whether the fused route would be taken with and without collection."""
    import dataclasses
    import os

    from compactfusion_tpu_torch.compact.stats import StatsLogger

    os.environ["CFTPU_COLLECT_DIR"] = collect_dir
    m = tmesh.make_mesh(ParallelConfig(ring_degree=2))
    cfg = CompactConfig(enabled=True, compress_type=CompressType.BINARY, residual=1, error_feedback=True,
                        warmup_steps=1, log_stats=True)
    StatsLogger.reset()
    b, _, h, d = steps[0][0].shape
    state = tring.init_ring_state(2, b * s_local, h * d, torch.float32, 1)
    outs = []
    for i, step in enumerate(steps):
        q, k, v = _local(step, m, s_local)
        out, state = tring.compact_ring_attention(q, k, v, state, cfg=cfg, method=cfg.type_at(0, i), mesh=m,
                                                  fused=True)
        outs.append(out.numpy())
    quiet = dataclasses.replace(cfg, log_stats=False)
    routes = [tring._fused_route(q, k, state, quiet, CompressType.BINARY, 2, True)]
    del os.environ["CFTPU_COLLECT_DIR"]
    routes.append(tring._fused_route(q, k, state, quiet, CompressType.BINARY, 2, True))
    log = StatsLogger.instance()
    return {"records": dict(log.records), "spectra": dict(log.spectra), "outs": outs, "fused_routes": routes}


def latte_latents(rank, world, configs, params, vae_params, inputs):
    """Per configuration (name, ParallelConfig kwargs): the tiny fp32 Latte
    pipeline's final latents on this rank (32 x 32, 4 frames, 3 DDIM steps
    at guidance 4.5) from ``inputs`` = (text, mask, noise), the bytes its
    all-to-alls sent and the hidden width of this rank's first spatial ffn;
    None on a rank the configuration leaves idle.  Under "one process": the
    same run in this process without a mesh."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models.latte import latte_tiny
    from compactfusion_tpu_torch.models.vae import tiny_vae
    from compactfusion_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    tm = dataclasses.replace(latte_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tiny_vae(), dtype=torch.float32)
    tparams = params_from_numpy(params)
    text, mask, noise = (torch.from_numpy(a) for a in inputs)
    size = dict(num_steps=3, guidance_scale=4.5, height=32, width=32, num_frames=4)
    one = LattePipeline(tparams, None, LattePipelineConfig(model=tm, vae=tv, **size), "cpu")
    res = {"one process": (one(text, mask, latents=noise, decode=False).numpy(),)}
    for name, par in configs:
        parallel = ParallelConfig(**par)
        mesh = tmesh.make_mesh(parallel)
        if mesh is None:
            res[name] = None
            continue
        cfg = LattePipelineConfig(model=tm, vae=tv, parallel=parallel, **size)
        tmesh.Mesh.all_to_all.nbytes = 0
        pipe = LattePipeline(tparams, None, cfg, "cpu", mesh=mesh)
        lat = pipe(text, mask, latents=noise, decode=False)
        hidden = pipe.params["spatial_blocks"]["ffn"]["fc1"]["w"].shape[-1]
        res[name] = (lat.numpy(), tmesh.Mesh.all_to_all.nbytes, hidden)
    return res


def video_pipeline_latents(rank, world, family, configs, params, inputs):
    """Per configuration (name, ParallelConfig kwargs, CompactConfig kwargs
    or None) of the tiny fp32 ``family`` pipeline ("consisid": inputs (txt,
    ids, noise), 32 x 48, 9 frames, guidance 6; "hunyuanvideo": (txt, mask,
    noise), 32 x 32, 5 frames), 3 steps: the final latents on this rank and
    the largest EF cache deviation across the ring."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy

    if family == "consisid":
        from compactfusion_tpu_torch.models.consisid import consisid_tiny as tiny
        from compactfusion_tpu_torch.pipelines.consisid import ConsisIDPipeline as Pipe
        from compactfusion_tpu_torch.pipelines.consisid import ConsisIDPipelineConfig as Cfg

        size = dict(height=32, width=48, num_frames=9, guidance_scale=6.0)
    else:
        from compactfusion_tpu_torch.models.hunyuanvideo import hunyuanvideo_tiny as tiny
        from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline as Pipe
        from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipelineConfig as Cfg

        size = dict(height=32, width=32, num_frames=5)
    tm = dataclasses.replace(tiny(), dtype=torch.float32)
    tparams = params_from_numpy(params)
    a, b, noise = (torch.from_numpy(x) for x in inputs)
    res = {}
    for name, par, compact in configs:
        parallel = ParallelConfig(**par)
        ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
        cfg = Cfg(model=tm, parallel=parallel, compact=CompactConfig(**ckw), num_steps=3, **size)
        pipe = Pipe(tparams, None, cfg, "cpu", mesh=tmesh.make_mesh(parallel))
        tring.max_consistency_dev = 0.0
        if family == "consisid":
            lat = pipe(a, latents=noise, id_states=b, decode=False)
        else:
            lat = pipe(a, None, b, latents=noise, decode=False)
        res[name] = (lat.numpy(), tring.max_consistency_dev)
    return res


def stepvideo_latents(rank, world, configs, params, inputs):
    """Per configuration (name, ParallelConfig kwargs, CompactConfig kwargs
    or None) of the tiny fp32 Step-Video pipeline (128 x 128, 17 frames: 48
    tokens, 3 steps at guidance 9) from ``inputs`` = (txt [cond, uncond],
    noise): the final latents on this rank and the largest EF cache
    deviation across the ring; None on a rank the configuration leaves
    idle.  Every rank passes the full tree and cuts its own share."""
    import dataclasses

    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models.stepvideo import stepvideo_tiny
    from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipeline, StepVideoPipelineConfig

    tm = dataclasses.replace(stepvideo_tiny(), dtype=torch.float32)
    tparams = params_from_numpy(params)
    txt, noise = (torch.from_numpy(a) for a in inputs)
    res = {}
    for name, par, compact in configs:
        parallel = ParallelConfig(**par)
        mesh = tmesh.make_mesh(parallel)
        if mesh is None:
            res[name] = None
            continue
        ckw = {} if compact is None else dict(compact, compress_type=CompressType(compact["compress_type"]))
        cfg = StepVideoPipelineConfig(model=tm, parallel=parallel, compact=CompactConfig(**ckw), num_steps=3,
                                      height=128, width=128, num_frames=17)
        tring.max_consistency_dev = 0.0
        lat = StepVideoPipeline(tparams, cfg, "cpu", mesh=mesh)(txt, latents=noise)
        res[name] = (lat.numpy(), tring.max_consistency_dev)
    return res


def examples_outputs(rank, world, argv, weights, noise, lossless_layers, out_dir):
    """The two last examples on 4 ranks: ``external_usp_example.main`` on
    this rank's CPU (U2 x R2), then ``per_layer_schedule_example.main`` at
    ``argv`` (ring 2: ranks 2 and 3 only join its groups) with the first
    ``lossless_layers`` layers IDENTITY, its runner on the CPU with
    ``weights`` carried across and ``noise`` as every call's latents, the EF
    consistency check on, saving under ``out_dir``.  Returns the USP error,
    then the latents, the largest EF deviation and the saved paths."""
    import os

    from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
    from compactfusion_tpu_torch.examples import external_usp_example
    from compactfusion_tpu_torch.examples import per_layer_schedule_example as example

    out = {"usp_rel_err": external_usp_example.main(device=torch.device("cpu"))}
    parser = FlexibleArgumentParser()
    xFuserArgs.add_cli_args(parser)
    par = xFuserArgs.from_cli_args(parser.parse_args(argv)).create_config()[0].parallel_config
    if rank >= par.world_size:
        _join_groups(par)
        return out

    class Carried(example.xDiTParallel):
        def __init__(self, engine_config, input_config, checkpoint=None, device="cuda"):
            super().__init__(engine_config, input_config, checkpoint, device="cpu")
            carry_weights(self, weights)

        def __call__(self, generator=None, decode=None, latents=None):
            return super().__call__(generator, decode, torch.from_numpy(noise) if latents is None else latents)

    example.xDiTParallel, example.LOSSLESS_LAYERS = Carried, lossless_layers
    os.chdir(out_dir)
    tring.max_consistency_dev = 0.0
    lat, saved = example.main(argv, check_consistency=True)
    out.update(latents=lat.numpy(), consistency_dev=tring.max_consistency_dev, saved=saved)
    return out
