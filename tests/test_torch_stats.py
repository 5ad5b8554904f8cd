"""Compression statistics and the activation collector vs the JAX package.

* ``compression_metrics`` and the ``StatsLogger`` dumps and summary on the
  same records equal JAX's (metrics within 1e-6 relative).
* ``log_stats`` taps: the ring emulation (``SimRingAttn``, ring 2, a WARMUP
  then two BINARY calls) and the compressed ring on one device record the
  same keys and steps as JAX's, metrics within 1e-5 relative, spectra
  within 1e-4; the outputs stay the same with the taps on.
* The recorded divergence: the spectrum is taken on the tensor's device
  (``torch.linalg.svdvals``), not from a host copy; its top-k agrees with
  JAX's ``_host_spectrum`` within 1e-4 relative, also on a rank-deficient
  input.
* ``CFTPU_COLLECT_DIR``: explicit and auto-sequence names and values as
  JAX's collector writes them; the compressed ring's q/k/v/kbase/vbase
  taps on one device and, in one spawn of 2 gloo processes, at ring 2
  against JAX's 2-device mesh (the same file names, shapes and values, the
  tagged stats keys), with the fused route off while collecting; the
  PixArt pipeline's per-step latents tap against JAX's, the FLUX one's
  count.  bf16 tensors are written as float32 (recorded in the collector).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.compact import stats as jstats
from compactfusion_tpu.compact.ring import compact_ring_attention as jcompact
from compactfusion_tpu.compact.ring import init_ring_state as jinit
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.models import attn_impl as jattn
from compactfusion_tpu.utils import collector as jcollector
from compactfusion_tpu_torch.compact import ring as tring
from compactfusion_tpu_torch.compact import stats as tstats
from compactfusion_tpu_torch.compact.ring import tree_map
from compactfusion_tpu_torch.config import CompactConfig, CompressType
from compactfusion_tpu_torch.models import attn_impl as tattn
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.utils import collector as tcollector
from tests.helpers import rel_err
from tests.test_torch_rank_fns import stats_ring_outputs

B, H, D, S_LOCAL = 1, 2, 8, 16
METRIC_REL, SPECTRUM_REL = 1e-5, 1e-4


def _steps(ring, n=3, seed=4):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((B, S_LOCAL * ring, H, D)) for _ in range(3)]
    out = []
    for _ in range(n):
        x = [a + 0.1 * rng.standard_normal(a.shape) for a in x]
        out.append(tuple(a.astype(np.float32) for a in x))
    return out


def _logs_agree(got_records, got_spectra, want_records, want_spectra):
    assert sorted(got_records) == sorted(want_records) and sorted(got_spectra) == sorted(want_spectra)
    for key, recs in want_records.items():
        assert [s for s, _ in got_records[key]] == [s for s, _ in recs], key
        for (_, g), (_, w) in zip(got_records[key], recs):
            assert sorted(g) == sorted(w)
            for name in w:
                assert abs(g[name] - w[name]) <= METRIC_REL * max(abs(w[name]), 1e-6), (key, name)
    for key, rows in want_spectra.items():
        assert len(got_spectra[key]) == len(rows), key
        for g, w in zip(got_spectra[key], rows):
            assert rel_err(g, w) < SPECTRUM_REL, key


def test_metrics_dumps_and_summary_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    x_hat = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    want = {k: float(v) for k, v in jstats.compression_metrics(jnp.asarray(x), jnp.asarray(x_hat)).items()}
    got = {k: float(v) for k, v in tstats.compression_metrics(torch.from_numpy(x), torch.from_numpy(x_hat)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k])
    jl, tl = jstats.StatsLogger(), tstats.StatsLogger()
    for step in range(4):
        m = {k: v * (1 + step) for k, v in want.items()}
        jl.log("k", step, m)
        tl.log("k", step, m)
        for log in (jl, tl):
            log.spectra["k-delta"].append([3.0 - step, 1.0])
    for log, sent, raw in ((jl, 10, 400), (tl, 10, 400)):
        log.account_volume(sent, raw)
    for depth in (None, 2):
        assert tl.dump_eigenvalues(str(tmp_path / "t.json"), depth) == jl.dump_eigenvalues(
            str(tmp_path / "j.json"), depth)
        assert tl.dump_err_vs_steps(str(tmp_path / "t.json"), depth) == jl.dump_err_vs_steps(
            str(tmp_path / "j.json"), depth)
        assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    assert tl.summary() == jl.summary() and tl.compression_ratio == jl.compression_ratio == 40.0
    # log_volume counts a payload's wire bytes against the raw tensor's
    from compactfusion_tpu_torch.compact import codecs as tcodecs

    v = tstats.StatsLogger()
    xt = torch.from_numpy(x)
    v.log_volume(tcodecs.encode(xt, CompressType.BINARY), xt)
    assert v.raw_bytes == x.nbytes and v.sent_bytes == tcodecs.payload_nbytes(tcodecs.encode(xt, CompressType.BINARY))
    assert tstats.StatsLogger.instance() is tstats.StatsLogger.instance()


@pytest.mark.parametrize("rows,cols,rank", [(64, 32, None), (32, 48, None), (96, 40, 3)])
def test_spectrum_on_device_matches_host_svd(rows, cols, rank):
    """The recorded divergence: top-k singular values from svdvals on the
    tensor's device against JAX's host-side numpy SVD."""
    rng = np.random.default_rng(rows + cols)
    a = rng.standard_normal((rows, cols)).astype(np.float32)
    if rank:
        a = (rng.standard_normal((rows, rank)) @ rng.standard_normal((rank, cols))).astype(np.float32)
    for top_k in (8, 64):
        want = np.asarray(jstats._host_spectrum(a, top_k))
        got = tstats.spectrum(torch.from_numpy(a), top_k).numpy()
        assert got.shape == want.shape
        assert rel_err(got, want) < SPECTRUM_REL
        assert np.allclose(got, want, rtol=1e-4, atol=1e-4 * want[0])


def test_sim_ring_taps_match_jax():
    ring = 2
    kw = dict(enabled=True, warmup_steps=1, log_stats=True)
    jcfg, tcfg = JCompact(**kw), CompactConfig(**kw)
    jst = jax.tree_util.tree_map(lambda a: a[0], jattn.SimRingAttn(jcfg, JType.WARMUP, ring).init_state(
        1, B, S_LOCAL * ring, H, D, jnp.float32))
    tst = tree_map(lambda a: a[0], tattn.SimRingAttn(tcfg, CompressType.WARMUP, ring).init_state(
        1, B, S_LOCAL * ring, H, D, torch.float32))
    jstats.StatsLogger.reset()
    tstats.StatsLogger.reset()
    for step, (q, k, v) in enumerate(_steps(ring)):
        ref, jst = jattn.SimRingAttn(jcfg, jcfg.type_at(0, step), ring)(*map(jnp.asarray, (q, k, v)), jst)
        quiet = tree_map(torch.clone, tst)
        out, tst = tattn.SimRingAttn(tcfg, tcfg.type_at(0, step), ring)(*map(torch.from_numpy, (q, k, v)), tst)
        plain, _ = tattn.SimRingAttn(dataclasses.replace(tcfg, log_stats=False), tcfg.type_at(0, step), ring)(
            *map(torch.from_numpy, (q, k, v)), quiet)
        assert torch.equal(out, plain) and rel_err(out.numpy(), ref) < METRIC_REL
    jax.effects_barrier()
    jl, tl = jstats.StatsLogger.instance(), tstats.StatsLogger.instance()
    assert len(jl.records["k"]) == 2 * ring and len(jl.spectra["k-delta"]) == 2 * ring
    _logs_agree(tl.records, tl.spectra, jl.records, jl.spectra)


def test_compact_ring_taps_one_device_match_jax(tmp_path, monkeypatch):
    """ring_size 1 on one device, as the JAX package's own test: the stats
    keys untagged, and the collector's five taps per call."""
    cfg_kw = dict(enabled=True, compress_type="binary", residual=1, error_feedback=True, fastpath=False,
                  log_stats=True)
    jcfg = JCompact(**dict(cfg_kw, compress_type=JType.BINARY))
    tcfg = CompactConfig(**dict(cfg_kw, compress_type=CompressType.BINARY))
    q, k, v = _steps(1, 1)[0]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(jdir))
    jcollector._SEQ.clear()
    jstats.StatsLogger.reset()
    mesh = JMesh(np.array(jax.devices()[:1]), ("ring",))
    jst = jinit(1, B * S_LOCAL, H * D, jnp.float32, 1)

    def body(q, k, v, st):
        return jcompact(q, k, v, st, cfg=jcfg, method=JType.BINARY, ring_size=1)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=(P(), P()),
                              check_vma=False))
    ref, _ = f(*map(jnp.asarray, (q, k, v)), jst)
    np.asarray(ref)
    jax.effects_barrier()
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(tdir))
    tcollector._SEQ.clear()
    tstats.StatsLogger.reset()
    tst = tring.init_ring_state(1, B * S_LOCAL, H * D, torch.float32, 1)
    out, _ = tring.compact_ring_attention(*map(torch.from_numpy, (q, k, v)), tst, cfg=tcfg,
                                          method=CompressType.BINARY, mesh=None)
    assert rel_err(out.numpy(), np.asarray(ref)) < METRIC_REL
    jl, tl = jstats.StatsLogger.instance(), tstats.StatsLogger.instance()
    assert sorted(tl.records) == ["k", "v"] and sorted(tl.spectra) == ["k-activation", "k-delta"]
    _logs_agree(tl.records, tl.spectra, jl.records, jl.spectra)
    _same_files(tdir, jdir, {"q", "k", "v", "kbase", "vbase"}, 1)


def _same_files(tdir, jdir, names, per_name, rel=1e-6):
    """The same file names in both directories, ``per_name`` of each name,
    equal shapes and values within ``rel``."""
    got, want = sorted(p.name for p in tdir.iterdir()), sorted(p.name for p in jdir.iterdir())
    assert got == want, (got, want)
    assert {n.rsplit("_", 2)[0] for n in got} == names and len(got) == per_name * len(names)
    for name in got:
        a, b = np.load(tdir / name), np.load(jdir / name)
        assert a.shape == b.shape, name
        assert rel_err(a, b) <= rel, name


def test_collector_addressing_matches_jax(tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for d, mod, arr in ((jdir, jcollector, jnp.asarray(x)), (tdir, tcollector, torch.from_numpy(x))):
        monkeypatch.setenv("CFTPU_COLLECT_DIR", str(d))
        mod._SEQ.clear()
        assert mod.enabled()
        mod.collect(arr, "q", 2, 7)
        for _ in range(3):
            mod.collect(arr, "latents")
        mod.collect(arr, "k", rank=1)
    jax.effects_barrier()
    got = sorted(p.name for p in tdir.iterdir())
    assert got == sorted(p.name for p in jdir.iterdir()) == [
        "k_n00000_r1.npy", "latents_n00000_r0.npy", "latents_n00001_r0.npy", "latents_n00002_r0.npy",
        "q_s2_l7_r0.npy"]
    for name in got:
        np.testing.assert_array_equal(np.load(tdir / name), np.load(jdir / name))
    # off: no file; bf16 goes to disk as float32
    monkeypatch.delenv("CFTPU_COLLECT_DIR")
    assert not tcollector.enabled()
    tcollector.collect(torch.ones(2), "off")
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(tmp_path / "bf16"))
    tcollector.collect(torch.full((2, 2), 1.5, dtype=torch.bfloat16), "half", 0, 0)
    half = np.load(tmp_path / "bf16" / "half_s0_l0_r0.npy")
    assert half.dtype == np.float32 and (half == 1.5).all()
    assert not list(tmp_path.glob("off*"))


@pytest.fixture(scope="module")
def ring_spawn(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_ring")
    return d, tmesh.spawn_local(stats_ring_outputs, 2, "gloo", _steps(2), str(d), S_LOCAL, threads=1, timeout=300)


def test_ring2_taps_across_ranks_match_jax(ring_spawn, tmp_path, monkeypatch):
    """Ring 2 in 2 gloo processes against JAX's 2-device mesh: the files of
    both ranks, the stats keys tagged by the ring index, the fused route
    off while collecting (on without collection)."""
    tdir, ranks = ring_spawn
    jdir = tmp_path / "jax"
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(jdir))
    jcollector._SEQ.clear()
    jstats.StatsLogger.reset()
    jcfg = JCompact(enabled=True, compress_type=JType.BINARY, residual=1, error_feedback=True, warmup_steps=1,
                    log_stats=True, fastpath=False)
    mesh = JMesh(np.array(jax.devices()[:2]), ("ring",))
    spec = P(None, "ring", None, None)
    state = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (2,) + a.shape),
                                   jinit(2, B * S_LOCAL, H * D, jnp.float32, 1))
    for i, (q, k, v) in enumerate(_steps(2)):
        method = jcfg.type_at(0, i)

        def body(q, k, v, st, method=method):
            st = jax.tree_util.tree_map(lambda a: a[0], st)
            out, new = jcompact(q, k, v, st, cfg=jcfg, method=method, axis_name="ring", ring_size=2, fused=True)
            return out, jax.tree_util.tree_map(lambda a: a[None], new)

        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P("ring")),
                                   out_specs=(spec, P("ring")), check_vma=False))
        ref, state = fn(*map(jnp.asarray, (q, k, v)), state)
        for rank, res in enumerate(ranks):
            assert rel_err(res["outs"][i], np.split(np.asarray(ref), 2, axis=1)[rank]) < METRIC_REL
    jax.effects_barrier()
    _same_files(tdir, jdir, {"q", "k", "v", "kbase", "vbase"}, 2 * 3)
    jl = jstats.StatsLogger.instance()
    for rank, res in enumerate(ranks):
        mine = lambda d: {k: v for k, v in d.items() if k.endswith(f"@r{rank}")}
        assert sorted(res["records"]) == [f"k@r{rank}", f"v@r{rank}"]
        _logs_agree(res["records"], res["spectra"], mine(jl.records), mine(jl.spectra))
        assert res["fused_routes"] == [False, True]


def test_pipeline_latents_taps(tmp_path, monkeypatch):
    """The tiny PixArt pipeline (one device, 3 steps) writes the same
    per-step latents files as the JAX pipeline; FLUX writes one a step."""
    from compactfusion_tpu.models import pixart as jpix
    from compactfusion_tpu.models import vae as jvae
    from compactfusion_tpu.parallel.mesh import make_mesh
    from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPipe
    from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JCfg
    from compactfusion_tpu_torch.io.from_jax import params_from_numpy
    from compactfusion_tpu_torch.models import pixart as tpix
    from compactfusion_tpu_torch.models import vae as tvae
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    jm = dataclasses.replace(jpix.pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(jvae.tiny_vae(), dtype=jnp.float32)
    params = jpix.init_pixart(jax.random.PRNGKey(0), jm)
    jc = JCfg(model=jm, vae=jv, num_steps=3, height=64, width=64)
    rng = np.random.default_rng(2)
    text = rng.standard_normal((2, 1, 8, jm.text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 8), bool)
    noise = rng.standard_normal((1, jc.tokens, jm.patch ** 2 * jm.in_channels)).astype(np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(jdir))
    jcollector._SEQ.clear()
    pipe = JPipe(params, None, jc, make_mesh(jc.parallel, devices=jax.devices()[:1]))
    np.asarray(pipe._sample(params, jnp.asarray(text), jnp.asarray(mask), jnp.asarray(noise)))
    jax.effects_barrier()
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(tdir))
    tcollector._SEQ.clear()
    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tc = PixArtPipelineConfig(model=tm, vae=dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32), num_steps=3,
                              height=64, width=64)
    tp = PixArtPipeline(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)), None, tc, "cpu")
    tp(torch.from_numpy(text), torch.from_numpy(mask), latents=torch.from_numpy(noise), decode=False)
    _same_files(tdir, jdir, {"latents"}, 3, rel=2e-4)

    from compactfusion_tpu_torch.models import flux as tflux
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    fdir = tmp_path / "flux"
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(fdir))
    tcollector._SEQ.clear()
    fm = dataclasses.replace(tflux.flux_tiny(), dtype=torch.float32)
    fc = FluxPipelineConfig(model=fm, vae=tvae.tiny_vae(), num_steps=2, height=32, width=32)
    fp = FluxPipeline(tflux.init_flux(torch.Generator().manual_seed(0), fm), None, fc, "cpu")
    lat = fp(torch.zeros(1, 4, fm.text_dim), torch.zeros(1, fm.pooled_dim), generator=torch.Generator().manual_seed(1),
             decode=False)
    assert sorted(p.name for p in fdir.iterdir()) == ["latents_n00000_r0.npy", "latents_n00001_r0.npy"]
    np.testing.assert_array_equal(np.load(fdir / "latents_n00001_r0.npy"), lat.numpy())
