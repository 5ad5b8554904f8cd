"""Patch parallelism across ranks vs the JAX package, in fp32, at W = 4.

One spawn of 4 gloo processes (a ring-4 mesh) runs the port on the drift
inputs of ``tests/compact/test_patch_parallel.py``:

* ``compact_all_gather`` (BINARY, INT2, BINARY on int8 caches; residual 1
  + EF, 3 drifting steps): the W reconstructions and all W slots against
  the JAX gather (within 1e-6 relative: fp32 summation order), every slot
  bit-equal across the port's ranks, and the gathered bytes W times the
  payload's;
* ``PatchParallelAttn`` sync within 1e-5 of JAX's; compact with BINARY,
  INT2 and BINARY on int8 caches (warmup 2, 7 steps): outputs within 5e-5
  and all W slots within 1e-6 of JAX's (int8 caches: the slots decoded),
  the slots bit-equal across the ranks; async (DistriFusion: 2 warmup
  steps, then the stale gather) within 1e-5 of JAX's async on the warmup
  and the stale steps.

On int8 caches JAX's side runs eagerly (:func:`_eager_gather`): under
``jit`` XLA fuses the cache's dequantize and requantize and rounds a code
the other way at a near-tie (216.50002 gives 216 there, 217 eagerly and
in the port), and the binary codec's later signs follow the base that moved.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.compact.allgather import compact_all_gather as jgather
from compactfusion_tpu.compact.engine import ef_compress as jcompress
from compactfusion_tpu.compact.engine import ef_decompress as jdecompress
from compactfusion_tpu.compact.ring import init_ring_state as jinit
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.ops.attention import attn_with_lse as jattn
from compactfusion_tpu.parallel.mesh import AXIS_RING, make_mesh
from compactfusion_tpu.parallel.patch import PatchParallelAttn as JPatch
from compactfusion_tpu_torch.compact import codecs as tcodecs
from compactfusion_tpu_torch.config import CompressType
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.compact.test_patch_parallel import B, D, H, S, W, _drift, _runner, _state_stack
from tests.helpers import rel_err
from tests.test_torch_rank_fns import patch_outputs

SYNC_REL, OUT_REL, SLOT_REL = 1e-5, 5e-5, 1e-6
N, C = 32, 48  # compact_all_gather's own (N, C) per rank
EF = dict(residual=1, error_feedback=True)
COMPACT = {"binary": dict(compress_type="binary", **EF), "int2": dict(compress_type="int2", **EF),
           "binary-int8": dict(compress_type="binary", quantized_cache=True, **EF)}


def _np_steps(steps):
    return [tuple(np.asarray(t) for t in step) for step in steps]


def _runs():
    """(name, mode, CompactConfig kwargs, steps, each step's method)."""
    runs = [("sync", "sync", None, _np_steps(_drift(1)), [None])]
    for name, ckw in COMPACT.items():
        cfg = JCompact(enabled=True, warmup_steps=2, **dict(ckw, compress_type=JType(ckw["compress_type"])))
        runs.append((f"compact-{name}", "compact", dict(ckw, enabled=True, warmup_steps=2),
                     _np_steps(_drift(7, seed=1)), [cfg.type_at(0, s).value for s in range(7)]))
    runs.append(("async", "async", None, _np_steps(_drift(6, drift=0.02, seed=2)),
                 ["warmup"] * 2 + ["identity"] * 4))
    return runs


def _gather_steps(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((W * N, C))
    out = []
    for _ in range(3):
        x = x + 0.05 * rng.standard_normal(x.shape)
        out.append(x.astype(np.float32))
    return out


GATHER = [(f"gather-{name}", dict(ckw, enabled=True, warmup_steps=0), _gather_steps(i))
          for i, (name, ckw) in enumerate(COMPACT.items())]


@pytest.fixture(scope="module")
def spawned():
    return tmesh.spawn_local(patch_outputs, 4, "gloo", _runs(), GATHER, threads=1, timeout=300)


def _slots(state):
    """A state's leaves as numpy, with the leading device axis."""
    return [np.asarray(t, np.float32) for t in jax.tree_util.tree_leaves(state)]


def _eager_gather(x_w, slots, cfg, method):
    """``compact_all_gather`` with its W sources in a loop, run eagerly:
    each source compressed against its own slot without updating it, then
    every payload decompressed into its slot.  (W, N, C) reconstructions
    and the new slots, leaves (W, N, C)."""
    slot = lambda i: jax.tree_util.tree_map(lambda a: a[i], slots)
    with jax.disable_jit():
        payloads = [jcompress(x, slot(i), cfg, method, update_cache=False)[0] for i, x in enumerate(x_w)]
        outs = [jdecompress(p, slot(i), cfg, method, update_cache=True) for i, p in enumerate(payloads)]
    return jnp.stack([o[0] for o in outs]), jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[o[1] for o in outs])


def _on_devices(slots):
    """The slots as every device holds them: leaves with a device axis."""
    return _slots(jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (W,) + a.shape), slots))


def _eager_patch(cfg, steps, methods):
    """``PatchParallelAttn`` compact mode with the gathers run eagerly
    (:func:`_eager_gather`); each rank's output rows of the attention."""
    impl = JPatch(cfg=cfg, mode="compact", world=W)
    state = jax.tree_util.tree_map(lambda a: a[0], impl.init_state(1, B, S // W, H, D, jnp.float32))
    res = []
    for (q, k, v), method in zip(steps, methods):
        own = lambda x: x.reshape(B, W, S // W, H * D).transpose(1, 0, 2, 3).reshape(W, -1, H * D)
        full = lambda g: g.reshape(W, B, S // W, H, D).transpose(1, 0, 2, 3, 4).reshape(B, S, H, D)
        gk, ks = _eager_gather(jnp.asarray(own(k)), state.k, cfg, JType(method))
        gv, vs = _eager_gather(jnp.asarray(own(v)), state.v, cfg, JType(method))
        state = type(state)(k=ks, v=vs)
        out, _ = jattn(jnp.asarray(q), full(gk), full(gv))
        res.append((np.split(np.asarray(out), W, axis=1), _on_devices(state)))
    return res


@functools.lru_cache(maxsize=None)
def _jax_patch(name):
    run = {r[0]: r for r in _runs()}[name]
    _, mode, ckw, steps, methods = run
    cfg = None if ckw is None else JCompact(**dict(ckw, compress_type=JType(ckw["compress_type"])))
    if cfg is not None and cfg.quantized_cache:
        return _eager_patch(cfg, steps, methods)
    state, res = None, []
    for (q, k, v), method in zip(steps, methods):
        impl = JPatch(cfg=cfg, method=None if method is None else JType(method), mode=mode, world=W)
        if state is None:
            state = _state_stack(impl)
        out, state = _runner(impl)(*map(jnp.asarray, (q, k, v)), state)
        res.append((np.split(np.asarray(out), W, axis=1), _slots(state)))
    return res


def _decoded(leaves, quantized):
    """The slots in fp32: int8 entries (codes, scale, min) decoded."""
    if not quantized:
        return leaves
    return [q * s + mn for q, s, mn in zip(leaves[::3], leaves[1::3], leaves[2::3])]


def _check_slots(spawned, key, step, leaves_of, ref_leaves, rel):
    """Every rank's slots against JAX's (device ``rank``'s) within ``rel``
    (0: bit for bit), and bit-equal to rank 0's."""
    quantized = "int8" in key
    for rank, res in enumerate(spawned):
        leaves = leaves_of(res[key][step])
        assert len(leaves) == len(ref_leaves)
        want_leaves = [w[rank].reshape(g.shape) for w, g in zip(ref_leaves, leaves)]
        for got, want in zip(_decoded(leaves, quantized), _decoded(want_leaves, quantized)):
            err = rel_err(got, want)
            assert err < rel if rel else np.array_equal(got, want), (key, step, rank, err)
        for got, first in zip(leaves, leaves_of(spawned[0][key][step])):
            np.testing.assert_array_equal(got, first)


def test_sync_gather_matches_jax(spawned):
    (ref_out, _), = _jax_patch("sync")
    for rank, res in enumerate(spawned):
        (out, leaves), = res["sync"]
        assert leaves == []
        assert rel_err(out, ref_out[rank]) < SYNC_REL, rank


@pytest.mark.parametrize("codec", list(COMPACT))
def test_compact_patch_attn_matches_jax(spawned, codec):
    """Outputs within 5e-5 and slots within 1e-6 of JAX's."""
    name = f"compact-{codec}"
    for step, (ref_out, ref_leaves) in enumerate(_jax_patch(name)):
        for rank, res in enumerate(spawned):
            assert rel_err(res[name][step][0], ref_out[rank]) < OUT_REL, (step, rank)
        _check_slots(spawned, name, step, lambda r: r[1], ref_leaves, SLOT_REL)


def test_async_patch_attn_matches_jax(spawned):
    """DistriFusion: warmup steps gather fresh K/V, later steps attend to the
    stale gather with the fresh local slice swapped in."""
    ref = _jax_patch("async")
    for step, (ref_out, ref_leaves) in enumerate(ref):
        for rank, res in enumerate(spawned):
            out, leaves = res["async"][step]
            assert rel_err(out, ref_out[rank]) < SYNC_REL, (step, rank)
        # the caches hold the gathered K/V of this step: the same bits on
        # every rank as in JAX's
        _check_slots(spawned, "async", step, lambda r: r[1], ref_leaves, 0)


@functools.lru_cache(maxsize=None)
def _jax_gather(name):
    _, ckw, steps = {g[0]: g for g in GATHER}[name]
    cfg = JCompact(**dict(ckw, compress_type=JType(ckw["compress_type"])))
    one = jinit(W, N, C, jnp.float32, 1, quantized=cfg.quantized_cache).k
    if cfg.quantized_cache:
        res = []
        for x in steps:
            got, one = _eager_gather(jnp.asarray(x).reshape(W, N, C), one, cfg, cfg.compress_type)
            res.append((np.broadcast_to(np.asarray(got)[None], (W,) + got.shape), _on_devices(one)))
        return res
    mesh = make_mesh(JParallel(ring_degree=W), devices=jax.devices()[:W])

    def body(x, state):
        state = jax.tree_util.tree_map(lambda a: a[0], state)
        got, new = jgather(x, state, cfg=cfg, method=cfg.compress_type, axis_name=AXIS_RING)
        return got[None], jax.tree_util.tree_map(lambda a: a[None], new)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS_RING), P(AXIS_RING)),
                               out_specs=(P(AXIS_RING), P(AXIS_RING)), check_vma=False))
    state = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (W,) + a.shape), one)
    res = []
    for x in steps:
        got, state = fn(jnp.asarray(x), state)
        res.append((np.asarray(got), _slots(state)))
    return res


@pytest.mark.parametrize("name", [g[0] for g in GATHER])
def test_compact_all_gather_matches_jax(spawned, name):
    cfg_kw = {g[0]: g for g in GATHER}[name][1]
    method = CompressType(cfg_kw["compress_type"])
    import torch

    payload = tcodecs.encode(torch.ones(N, C), method)
    for step, (ref_got, ref_leaves) in enumerate(_jax_gather(name)):
        for rank, res in enumerate(spawned):
            got, _, nbytes = res[name][step]
            assert got.shape == (W, N, C)
            assert rel_err(got, ref_got[rank]) < SLOT_REL, (step, rank)
            assert nbytes == W * tcodecs.payload_nbytes(payload)
            # every rank holds the same W reconstructions
            np.testing.assert_array_equal(got, spawned[0][name][step][0])
        _check_slots(spawned, name, step, lambda r: r[1], ref_leaves, SLOT_REL)
