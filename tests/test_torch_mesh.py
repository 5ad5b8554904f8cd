"""The port's merge, mesh and process-group plumbing vs the JAX package.

``merge_out_lse`` against the JAX merge; the rank layout of
``parallel.mesh`` against the JAX ``make_mesh`` device layout for several
``ParallelConfig``s; then one spawn of 4 gloo processes (port 0) builds
meshes for three configurations and exercises each axis group: the
coordinates and groups every rank sees, ``ring_shift`` of a mixed-dtype
payload, ``all_gather`` and ``all_reduce_sum``, and ``check_consistency``.
Configurations the port does not run yet raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.ops.merge import merge_out_lse as jmerge
from compactfusion_tpu.parallel import mesh as jmesh
from compactfusion_tpu_torch.config import ParallelConfig
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.ops.merge import merge_out_lse
from compactfusion_tpu_torch.parallel import mesh as tmesh
from compactfusion_tpu_torch.parallel.ring import ring_shift
from compactfusion_tpu_torch.parallel.usp import usp_wrap
from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
from tests.test_torch_rank_fns import mesh_checks, nonfinite_consistency

LAYOUTS = [dict(dp_degree=2, ring_degree=2), dict(cfg_degree=2, ring_degree=2), dict(ring_degree=4),
           dict(dp_degree=2, cfg_degree=2, ring_degree=2), dict(ulysses_degree=2, ring_degree=2, tp_degree=2),
           dict(pp_degree=2, cfg_degree=2, ulysses_degree=2)]
SPAWNED = LAYOUTS[:3]


def test_merge_out_lse_matches_jax():
    rng = np.random.default_rng(0)
    parts = [(rng.standard_normal((2, 8, 3, 4)).astype(np.float32),
              (rng.standard_normal((2, 3, 8)) * 3).astype(np.float32)) for _ in range(3)]
    jo = jl = to = tl = None
    for o, l in parts:
        jo, jl = jmerge(jo, jl, jnp.asarray(o), jnp.asarray(l))
        to, tl = merge_out_lse(to, tl, torch.from_numpy(o), torch.from_numpy(l))
    assert to.dtype == torch.float32 and tl.shape == (2, 3, 8)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda kw: "x".join(f"{k[:-7]}{v}" for k, v in kw.items()))
def test_rank_grid_matches_jax_make_mesh(layout):
    jm = jmesh.make_mesh(JParallel(**layout), devices=jax.devices())
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert jm.axis_names == tmesh.MESH_AXIS_ORDER
    np.testing.assert_array_equal(tmesh.rank_grid(ParallelConfig(**layout)), ids)


def test_single_process_mesh_and_environment(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed_environment("gloo", device="cpu") == torch.device("cpu")
    m = tmesh.make_mesh(ParallelConfig())
    assert all(m.axis_size(a) == 1 and m.axis_index(a) == 0 for a in tmesh.MESH_AXIS_ORDER)
    x = (torch.ones(3),)
    assert ring_shift(x, m, "ring") is x
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(ParallelConfig(ring_degree=2))


def test_environment_raises_without_a_cuda_device(monkeypatch):
    """The default device is the GPU: a rank that finds none raises rather
    than carry on on the CPU, under either backend."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("nccl", "gloo"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.init_distributed_environment(backend)
    with pytest.raises(ValueError):
        tmesh.init_distributed_environment("gloo", device="tpu")


@pytest.fixture(scope="module")
def spawned():
    return tmesh.spawn_local(mesh_checks, 4, "gloo", SPAWNED, threads=1, timeout=300)


@pytest.mark.parametrize("layout", SPAWNED, ids=lambda kw: "x".join(f"{k[:-7]}{v}" for k, v in kw.items()))
def test_mesh_groups_across_gloo_ranks(spawned, layout):
    """Each rank's coordinates and lines follow the rank grid; the ring
    shift brings the previous ring rank's payload, bit for bit and byte for
    byte; gather, sum and the consistency oracle act within the ring line."""
    grid = tmesh.rank_grid(ParallelConfig(**layout))
    key = tuple(sorted(layout.items()))
    for rank, res in enumerate(spawned):
        r = res[key]
        where = tuple(int(i) for i in np.argwhere(grid == rank)[0])
        assert tuple(r["coords"][a] for a in tmesh.MESH_AXIS_ORDER) == where
        for ax, name in enumerate(tmesh.MESH_AXIS_ORDER):
            idx = list(where)
            idx[ax] = slice(None)
            assert r["lines"][name] == [int(x) for x in grid[tuple(idx)]]
        line = r["lines"]["ring"]
        prev = line[(line.index(rank) - 1) % len(line)]
        assert r["shift"] == [[float(prev)] * 6, [prev + 0.5] * 5, [prev * 10.0] * 2]
        assert r["shift_dtypes"] == ["torch.uint8", "torch.bfloat16", "torch.float32"]
        assert r["shift_bytes"] == 6 + 10 + 8
        assert r["gather"] == [float(x) for x in line]
        assert r["sum"] == float(sum(line))
        assert r["dev_same"] == 0.0 and r["dev_diff"] > 0.0


# PipeFusion (with Ulysses too), TP and the VAE ranks are ported: each
# configuration builds, and its pipeline raises without this rank's meshes
@pytest.mark.parametrize("unported", [dict(ulysses_degree=2, pp_degree=2), dict(pp_degree=2), dict(tp_degree=2),
                                      dict(vae_parallel_size=1)],
                         ids=["ulysses", "pp", "tp", "vae_parallel_size"])
def test_unported_parallel_configs_raise(unported):
    tm, tv = tpix.pixart_tiny(), tvae.tiny_vae()
    cfg = PixArtPipelineConfig(model=tm, vae=tv, parallel=ParallelConfig(**unported), height=64, width=64)
    with pytest.raises(ValueError, match="mesh"):
        PixArtPipeline({}, {}, cfg, "cpu")


def test_ported_parallel_configs_build_and_need_a_mesh():
    tm, tv = tpix.pixart_tiny(), tvae.tiny_vae()
    cfg = PixArtPipelineConfig(model=tm, vae=tv, height=64, width=64,
                               parallel=ParallelConfig(cfg_degree=2, ring_degree=2, use_fused_ring=True))
    assert cfg.parallel.world_size == 4
    with pytest.raises(ValueError, match="mesh"):
        PixArtPipeline({}, {}, cfg, "cpu")
    with pytest.raises(ValueError, match="mesh of"):
        PixArtPipeline({}, {}, cfg, "cpu", mesh=tmesh.make_mesh(ParallelConfig()))
    # Ulysses is ported: it needs this rank's mesh for its all-to-all
    PixArtPipelineConfig(model=tm, vae=tv, height=64, width=64, parallel=ParallelConfig(ulysses_degree=2))
    with pytest.raises(ValueError, match="Ulysses"):
        usp_wrap(lambda *a: a, *(torch.zeros(1, 2, 1, 8) for _ in range(3)), ulysses_size=2)


def _jax_oracle(value):
    """JAX's oracle on a 2-device ring whose caches are equal on both
    devices, with ``value`` in one slot (None: clean): the deviation and
    whether ``_consistency_assert`` raised."""
    from jax.sharding import PartitionSpec as P

    from compactfusion_tpu.compact import ring as jring
    from compactfusion_tpu.compact.engine import check_consistency as jcheck

    st = jring.init_ring_state(2, 4, 8, jnp.float32, 1)
    if value is not None:
        st = st._replace(k=st.k._replace(base=st.k.base.at[1, 2, 3].set(value)))
    mesh = jmesh.make_mesh(JParallel(ring_degree=2), devices=jax.devices()[:2])
    spec = jax.tree_util.tree_map(lambda _: P(), st)

    def run(fn):
        return jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=P(), check_vma=False)(st)

    dev = float(run(lambda s: jcheck(s.k, "ring")))
    try:
        jax.block_until_ready(run(lambda s: (jring._consistency_assert(s, "ring"), jnp.zeros(()))[1]))
        raised = False
    except Exception:  # the host callback's AssertionError, as the runtime wraps it
        raised = True
    return dev, raised


def test_consistency_oracle_flags_nonfinite_caches():
    """Caches equal on both ranks but holding a NaN or an Inf in one slot:
    the oracle returns a non-finite deviation and ``consistency_assert``
    raises, as JAX's does on a 2-device mesh; clean caches still give 0."""
    ranks = tmesh.spawn_local(nonfinite_consistency, 2, "gloo", threads=1, timeout=120)
    for case, value in (("clean", None), ("nan", float("nan")), ("inf", float("inf"))):
        jdev, jraised = _jax_oracle(value)
        for res in ranks:
            dev, raised = res[case]
            assert raised == jraised == (value is not None), case
            if value is None:
                assert dev == jdev == 0.0
            else:
                assert np.isnan(dev) and not np.isfinite(jdev), case
