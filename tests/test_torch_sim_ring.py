"""The single-device compressed-ring emulation (``SimRingAttn``) vs the JAX
package for every codec, at ring 2, on the CPU.

Each case runs a WARMUP call and then two codec calls against the carried
EF state, fp32 on both sides.  Attention outputs and EF bases agree to 1e-5
relative (the engine bound of test_torch_engine.py: the same fp32 codec
arithmetic, payload codes equal), and to 1e-4 where a low-rank fit is
involved (test_torch_lowrank.py, with the JAX start basis handed to the
port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.compact import codecs as jcodecs
from compactfusion_tpu.config import CompactConfig as JCompact
from compactfusion_tpu.config import CompressType as JType
from compactfusion_tpu.models import attn_impl as jattn
from compactfusion_tpu_torch.compact import codecs as tcodecs
from compactfusion_tpu_torch.compact.ring import tree_map
from compactfusion_tpu_torch.config import CompactConfig as TCompact
from compactfusion_tpu_torch.config import CompressType as TType
from compactfusion_tpu_torch.models import attn_impl as tattn
from tests.helpers import rel_err
from tests.test_torch_codecs import CASES, LOW_RANK, LOWRANK_REL
from tests.test_torch_lowrank import use_jax_init_q


@pytest.mark.parametrize("codec,rank,quantized", [(m, r, False) for m, r in CASES if r != 4]
                         + [("int2", -1, True), ("binary", 2, True)])
def test_sim_ring_codecs_match_jax(codec, rank, quantized, monkeypatch):
    """Every codec, and int8-quantized caches for two of them; AWL takes its
    row weights from the V chunk."""
    use_jax_init_q(monkeypatch)
    rel = LOWRANK_REL if codec in LOW_RANK or rank > 0 else 1e-5
    rng = np.random.default_rng(len(codec))
    b, s, h, d = 2, 16, 2, 16
    x = [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]
    kw = dict(enabled=True, warmup_steps=1, comp_rank=rank, quantized_cache=quantized)
    jcfg = JCompact(compress_type=JType(codec), **kw)
    tcfg = TCompact(compress_type=TType(codec), **kw)
    jst = jax.tree_util.tree_map(lambda a: a[0], jattn.SimRingAttn(
        jcfg, JType.WARMUP, 2).init_state(1, b, s, h, d, jnp.float32))
    tst = tattn.SimRingAttn(tcfg, TType.WARMUP, 2).init_state(
        1, b, s, h, d, torch.float32)
    tst = tree_map(lambda a: a[0], tst)
    for step in range(3):
        q, k, v = (a + 0.05 * step * rng.standard_normal(a.shape).astype(np.float32) for a in x)
        jm, tm = jcfg.type_at(0, step), tcfg.type_at(0, step)
        ref, jst = jattn.SimRingAttn(jcfg, jm, 2)(*map(jnp.asarray, (q, k, v)), jst)
        out, tst = tattn.SimRingAttn(tcfg, tm, 2)(*map(torch.from_numpy, (q, k, v)), tst)
        assert rel_err(out.numpy(), ref) < rel, step
        for t, j in ((tst.k.base, jst.k.base), (tst.v.base, jst.v.base)):
            if quantized:  # int8 entries: compare what they decode to
                t, j = tcodecs.decode_int8(t), jcodecs.decode_int8(j)
            assert rel_err(t.numpy(), j) < rel, step
