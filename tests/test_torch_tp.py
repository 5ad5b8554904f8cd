"""Tensor parallelism across gloo processes vs the JAX package (fp32).

``parallel/tp.py`` cuts this rank's part of the full param tree:
feed-forwards split Megatron-style over tp (``FFN_KEYS``; fc2's bias
whole), the top-level block stacks over pp (``BLOCK_KEYS``), a nested stack
that reuses a name left whole (``tests/layers/test_tp.py``'s
``test_pp_specs_shard_only_top_level_stacks``).  One spawn of 8 gloo
processes runs the ffn at tp 4 against the serial ffn (``test_tp_ffn_
matches_serial``), and the tiny PixArt and FLUX pipelines at tp 2 x ring 2
x Ulysses 2 (FLUX's single blocks split the MLP half of ``proj_out``)
against JAX's pipelines at the same configuration and the port's one
process, within 2e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.parallel.tp import model_param_specs
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.parallel.tp import BLOCK_KEYS, FFN_KEYS, local_params, shard_params
from tests.helpers import rel_err
from tests.test_torch_pipefusion import jax_models, jax_sample, job, ranks_of, spawn_beside
from tests.test_torch_rank_fns import tp_outputs

BOUND = 2e-4
TP = dict(tp_degree=2, ring_degree=2, ulysses_degree=2)
CONFIGS = {"pixart": [("one", {}, None, {}), ("tp2-u2r2", TP, None, {})],
           "flux": [("one", {}, None, {}), ("tp2-u2r2", TP, None, {})]}
MODEL_KW = {"pixart": {}, "flux": {}}


def _ffn_inputs():
    params = jcm.init_ffn(jax.random.PRNGKey(0), 64, 256, dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 64), jnp.float32))
    return params, x


@pytest.fixture(scope="module")
def models():
    return jax_models(MODEL_KW)


@pytest.fixture(scope="module")
def spawned(models, jax_latents):
    params, x = _ffn_inputs()
    jobs = {family: job(models, family, configs, MODEL_KW) for family, configs in CONFIGS.items()}
    ffn_args = (jax.tree_util.tree_map(np.asarray, params), x)
    return spawn_beside(tp_outputs, 8, (ffn_args, jobs),
                        lambda: [jax_latents(f, c[0]) for f, configs in CONFIGS.items() for c in configs])


def test_tp_ffn_matches_serial(spawned):
    params, x = _ffn_inputs()
    ref = np.asarray(jcm.ffn(params, jnp.asarray(x)))
    for rank in range(4):
        assert rel_err(spawned[rank][0], ref) < 1e-5, rank


def test_tp_param_split_structure():
    """The port's cut of each rank is the JAX ``model_param_specs`` shard:
    the ffn's fc1 by columns, fc2 by rows, fc2's bias and every other leaf
    whole (the caller's tensors)."""
    jp = init_pixart(jax.random.PRNGKey(0), pixart_tiny())
    specs = model_param_specs(jp, tp=True)
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    parts = [shard_params(full, tp_index=i, tp_size=2) for i in range(2)]
    assert specs["blocks"]["ffn"]["fc1"]["w"] == jax.sharding.PartitionSpec(None, None, "tp")
    ffn = full["blocks"]["ffn"]
    torch.testing.assert_close(torch.cat([p["blocks"]["ffn"]["fc1"]["w"] for p in parts], dim=-1), ffn["fc1"]["w"],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p["blocks"]["ffn"]["fc1"]["b"] for p in parts], dim=-1), ffn["fc1"]["b"],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p["blocks"]["ffn"]["fc2"]["w"] for p in parts], dim=-2), ffn["fc2"]["w"],
                               rtol=0, atol=0)
    for p in parts:
        assert p["blocks"]["ffn"]["fc2"]["b"] is ffn["fc2"]["b"]
        assert p["blocks"]["attn_qkv"]["w"] is full["blocks"]["attn_qkv"]["w"]
        assert p["patch_embed"]["w"] is full["patch_embed"]["w"]
    assert FFN_KEYS == ("ffn", "img_ffn", "txt_ffn", "mlp") and "blocks" in BLOCK_KEYS
    assert local_params(full, None) is full


def test_pp_split_only_top_level_stacks():
    """Only the top-level block stacks split over pp: a nested stack that
    reuses a name (HunyuanVideo's ``refiner.blocks``) is no stage."""
    z = lambda *s: torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)  # noqa: E731
    params = {"double_blocks": {"attn": {"w": z(4, 8, 8)}}, "refiner": {"blocks": {"attn": {"w": z(2, 8, 8)}}},
              "perceiver": {"w": z(2, 8, 8)}, "x_embedder": {"w": z(8, 8)}}
    stages = [shard_params(params, pp_index=i, pp_size=2) for i in range(2)]
    for i, st in enumerate(stages):
        torch.testing.assert_close(st["double_blocks"]["attn"]["w"], params["double_blocks"]["attn"]["w"][2 * i:2 * i + 2],
                                   rtol=0, atol=0)
        assert st["refiner"]["blocks"]["attn"]["w"] is params["refiner"]["blocks"]["attn"]["w"]
        assert st["perceiver"]["w"] is params["perceiver"]["w"]
        assert st["x_embedder"]["w"] is params["x_embedder"]["w"]
    with pytest.raises(ValueError, match="split"):
        shard_params({"blocks": {"w": z(3, 2)}}, pp_index=0, pp_size=2)


@pytest.fixture(scope="module")
def jax_latents(models):
    @functools.lru_cache(maxsize=None)
    def run(family, name):
        _, par, compact, extra = {c[0]: c for c in CONFIGS[family]}[name]
        return jax_sample(models, family, par, compact, **extra)

    return run


@pytest.mark.parametrize("family", list(CONFIGS))
def test_tp2_u2r2_pipeline_matches_jax(spawned, jax_latents, family):
    results = [r[1] for r in spawned]
    ref = jax_latents(family, "tp2-u2r2")
    one = results[0][family, "one"][0]
    assert rel_err(one, jax_latents(family, "one")) < BOUND
    got = ranks_of(results, family, "tp2-u2r2")
    assert len(got) == 8
    for rank, (lat, _) in enumerate(got):
        assert rel_err(lat, ref) < BOUND, rank
        assert rel_err(lat, one) < BOUND, rank
        np.testing.assert_array_equal(lat, got[0][0])
