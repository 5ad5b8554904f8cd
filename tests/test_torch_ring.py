"""The uncompressed ring across ranks vs the JAX package, in fp32.

One spawn of 4 gloo processes runs every case of the port: ring 2 (on a
dp 2 x ring 2 mesh: both dp lines run the same inputs) and ring 4, with no
joint K/V and with joint K/V at the front and at the rear, unfused and
fused (the twin of the fused ring flash kernel on CPU tensors), a causal
ring, and ``usp_attention`` with a joint query.  Each rank's shard is held
against the JAX ``ring_attention`` on the 8-device CPU mesh (the fused
cases also against the Pallas ``ring_flash_attn_with_lse`` in interpret
mode) at 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from compactfusion_tpu.parallel.ring import ring_attention as jring
from compactfusion_tpu.parallel.usp import usp_attention as jusp
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err
from tests.test_torch_rank_fns import ring_outputs

B, S_LOCAL, H, D, SJ = 2, 16, 2, 16, 8
REL = 1e-5
# (ring, joint strategy, fused, causal, usp with joint q)
CASES = [(r, j, f, False, False) for r in (2, 4) for j in ("none", "front", "rear") for f in (False, True)]
CASES += [(4, "none", False, True, False), (2, "front", False, False, True), (4, "rear", True, False, True)]
INTERPRET = [(2, "none"), (4, "rear")]


def _inputs(ring):
    rng = np.random.default_rng(ring)
    s = S_LOCAL * ring
    q, k, v = (rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (rng.standard_normal((B, SJ, H, D)).astype(np.float32) for _ in range(3))
    return q, k, v, jq, jk, jv


@pytest.fixture(scope="module")
def spawned():
    inputs = {r: _inputs(r) for r in (2, 4)}
    return tmesh.spawn_local(ring_outputs, 4, "gloo", CASES, inputs, S_LOCAL, threads=1, timeout=300)


def _jax(ring, joint, causal, with_q, fused=False):
    q, k, v, jq, jk, jv = map(jnp.asarray, _inputs(ring))
    mesh = JMesh(np.array(jax.devices()[:ring]), ("ring",))
    spec = P(None, "ring", None, None)
    jkw = dict(joint_k=jk, joint_v=jv) if joint != "none" else {}

    def body(q, k, v, jq, jk, jv):
        kw = dict(joint_k=jk, joint_v=jv) if jkw else {}
        if with_q:
            return jusp(q, k, v, ulysses_size=1, ring_size=ring, ring_axis="ring", joint_q=jq,
                        joint_strategy=joint, fused_ring=fused, **kw)
        return jring(q, k, v, axis_name="ring", ring_size=ring, causal=causal,
                     joint_strategy=joint, fused=fused, **kw)

    f = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P(), P(), P()),
                      out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(q, k, v, jq, jk, jv))


def _shards(ref, ring):
    """The JAX output (sequence-sharded over the ring) as its R shards."""
    return np.split(ref, ring, axis=1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"ring{c[0]}-{c[1]}" + "-fused" * c[2]
                         + "-causal" * c[3] + "-usp" * c[4])
def test_ring_attention_matches_jax(spawned, case):
    """Every rank's shard (with a joint query: its joint rows and its own)
    against the JAX shard of its ring index."""
    ring, joint, fused, causal, with_q = case
    ref = _shards(_jax(ring, joint, causal, with_q), ring)
    for rank, (outs, nbytes) in enumerate(spawned):
        got = outs[case]
        assert got.shape == ref[rank % ring].shape
        assert rel_err(got, ref[rank % ring]) < REL, rank
        # the wire carries exactly the K/V shards: R - 1 shifts of (k, v)
        assert nbytes[case] == (ring - 1) * 2 * B * S_LOCAL * H * D * 4


@pytest.mark.parametrize("ring,joint", INTERPRET)
def test_fused_ring_twin_matches_pallas_interpret(spawned, ring, joint):
    """The fused route's twin against the Pallas fused ring kernel itself
    (interpret mode, its joint block merged after, as in both packages)."""
    ref = _shards(_jax(ring, joint, False, False, fused="interpret"), ring)
    for rank, (outs, _) in enumerate(spawned):
        assert rel_err(outs[(ring, joint, True, False, False)], ref[rank % ring]) < REL, rank
