"""The port's SD3 and HunyuanDiT checkpoint converters
(``io/hf.py::convert_sd3``, ``convert_hunyuandit``):

* equal to the JAX package's converters bit for bit, in fp32 and bf16, on
  the state dicts of ``tests/torch_ref.py::SD3Ref`` (3 blocks, the last
  ``context_pre_only``: its AdaLN-Continuous text norm laid out as
  AdaLN-Zero, its missing text out-projection and ffn zero-filled) and
  ``HunyuanDiTRef`` (2 down + 2 up blocks: up slot 0 without skip weights);
* the port's forwards on the converted weights against those references
  at 2e-4 (the fp32 bound of tests/io/test_backbone_parity.py), HunyuanDiT
  through ``hunyuandit_condition`` with padded CLIP and T5 masks;
* every key of the official inventories (``tests/io/fixtures/sd3-medium.
  keys.txt``: 24 blocks, 683 tensors; ``hunyuandit-v1.2.keys.txt``: 40
  blocks, 1544 tensors) read by the converters (SD3's persisted sin-cos
  table, which the model derives, apart, as in tests/io/test_real_keymaps.
  py), and the converted trees those of ``init_sd3`` / ``init_hunyuandit``.
  The names are the inventories'; widths are divided (SD3's by 32 above
  256, HunyuanDiT's by 8 from 512 up and its head dim 88 -> 11), so the
  whole depth converts in a few MB.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.models import hunyuandit as jhy
from compactfusion_tpu.models import sd3 as jsd3
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import hunyuandit as thy
from compactfusion_tpu_torch.models import sd3 as tsd3
from tests import torch_ref
from tests.helpers import rel_err
from tests.io.test_real_keymaps import TrackingState

BOUND = 2e-4
FIXTURES = Path(__file__).resolve().parent / "io" / "fixtures"
SD3_REF = dict(dim=64, depth=3, heads=4, patch=2, in_channels=4, text_dim=32, pooled_dim=16, sample_size=8,
               pos_embed_max_size=16, qk_norm=True)
HY_REF = dict(dim=64, depth=4, heads=4, patch=2, in_channels=4, out_channels=8, text_dim=32, t5_dim=48, text_len=6,
              text_len_t5=8, ffn_hidden=128, rope_axes=(8, 8))


def _state(ref):
    return {k: v.detach().numpy() for k, v in ref.state_dict().items()}


def _sd3_ref():
    torch.manual_seed(4)
    return torch_ref.SD3Ref(**SD3_REF).eval()


def _hy_ref():
    torch.manual_seed(16)
    return torch_ref.HunyuanDiTRef(**HY_REF).eval()


def _assert_same_tree(tp, jp, dtype):
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j).astype(np.float32), err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_sd3_matches_jax_bit_for_bit(dtype):
    state = _state(_sd3_ref())
    jcfg = dataclasses.replace(jsd3.sd3_tiny(), depth=3, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tsd3.sd3_tiny(), depth=3, dtype=getattr(torch, dtype))
    tp = thf.convert_sd3(state, tcfg)
    _assert_same_tree(tp, jhf.convert_sd3(state, jcfg), dtype)
    # the last (context_pre_only) block: text updates gated off, its
    # missing text weights zero
    last = tcm.layer_of(tp["blocks"], 2)
    assert not last["txt_mod"]["w"][:, 2 * 64:].any() and not last["txt_ffn"]["fc1"]["w"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_hunyuandit_matches_jax_bit_for_bit(dtype):
    state = _state(_hy_ref())
    jcfg = dataclasses.replace(jhy.hunyuandit_tiny(), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(thy.hunyuandit_tiny(), dtype=getattr(torch, dtype))
    tp = thf.convert_hunyuandit(state, tcfg)
    _assert_same_tree(tp, jhf.convert_hunyuandit(state, jcfg), dtype)
    # up slot 0 (global block depth/2) has no skip weights: zeros
    assert not tp["up_blocks"]["skip_proj"]["w"][0].any() and tp["up_blocks"]["skip_proj"]["w"][1].any()


def test_port_sd3_on_converted_weights_matches_sd3_ref():
    ref = _sd3_ref()
    cfg = dataclasses.replace(tsd3.sd3_tiny(), depth=3, dtype=torch.float32)
    params = thf.convert_sd3(_state(ref), cfg)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([99.0, 640.0], np.float32)
    text = rng.standard_normal((2, 6, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    with torch.no_grad():
        want = ref(*map(torch.from_numpy, (lat, t, text, pooled))).numpy()
    pos = tcm.cropped_pos_embed_2d(cfg.dim, 4, 4, cfg.pos_embed_max_size, cfg.base_size)
    tokens = tcm.patchify(torch.from_numpy(lat).permute(0, 2, 3, 1), cfg.patch)
    out, _ = tsd3.sd3_forward(params, tokens, torch.from_numpy(text), torch.from_numpy(pooled), torch.from_numpy(t),
                              cfg, pos_embed=pos)
    assert out.shape == want.shape and rel_err(out.numpy(), want) < BOUND


def test_port_hunyuandit_on_converted_weights_matches_hunyuandit_ref():
    ref = _hy_ref()
    cfg = dataclasses.replace(thy.hunyuandit_tiny(), dtype=torch.float32)
    params = thf.convert_hunyuandit(_state(ref), cfg)
    rng = np.random.default_rng(17)
    lat = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([88.0, 619.0], np.float32)
    clip = rng.standard_normal((2, 6, 32)).astype(np.float32)
    t5 = rng.standard_normal((2, 8, 48)).astype(np.float32)
    clip_mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    t5_mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0]], bool)
    ids = thy.hunyuandit_positions(4, 4)
    with torch.no_grad():
        want = ref(*map(torch.from_numpy, (lat, t, clip, t5, clip_mask, t5_mask)), ids).numpy()
    text, extra = thy.hunyuandit_condition(params, *map(torch.from_numpy, (clip, t5, clip_mask, t5_mask)), cfg)
    tokens = tcm.patchify(torch.from_numpy(lat).permute(0, 2, 3, 1), cfg.patch)
    out, _, _ = thy.hunyuandit_forward(params, tokens, torch.from_numpy(t), text, cfg,
                                       rope=tcm.rope_frequencies(ids, cfg.rope_axes), temb_extra=extra)
    assert rel_err(out.numpy(), want) < BOUND


def _inventory(name, scale):
    lines = [ln.split() for ln in (FIXTURES / name).read_text().splitlines() if ln and not ln.startswith("#")]
    return {k: tuple(scale(int(d)) for d in dims.split(",")) for k, dims in lines}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def test_convert_sd3_reads_every_key_of_the_sd3_medium_inventory():
    shapes = _inventory("sd3-medium.keys.txt", lambda n: n // 32 if n > 256 else n)
    assert len(shapes) == 683
    cfg = dataclasses.replace(tsd3.sd3_medium(), dim=48, text_dim=128, pooled_dim=64, dtype=torch.float32)
    assert (cfg.depth, cfg.heads, cfg.in_channels, cfg.qk_norm) == (24, 24, 16, False)
    state = TrackingState(shapes)
    params = thf.convert_sd3(state, cfg)
    assert set(state) - state.read == {"pos_embed.pos_embed"}
    assert _shapes(params) == _shapes(tsd3.init_sd3(torch.Generator().manual_seed(0), cfg))


def test_convert_hunyuandit_reads_every_key_of_the_v12_inventory():
    shapes = _inventory("hunyuandit-v1.2.keys.txt", lambda n: n // 8 if n >= 512 or n == 88 else n)
    assert len(shapes) == 1544
    cfg = dataclasses.replace(thy.hunyuandit_v12(), dim=176, text_dim=128, t5_dim=256, ffn_hidden=768,
                              rope_axes=(6, 6), dtype=torch.float32)
    assert (cfg.depth, cfg.heads, cfg.head_dim, cfg.text_len + cfg.text_len_t5) == (40, 16, 11, 333)
    state = TrackingState(shapes)
    params = thf.convert_hunyuandit(state, cfg)
    assert not set(state) - state.read, sorted(set(state) - state.read)[:10]
    assert _shapes(params) == _shapes(thy.init_hunyuandit(torch.Generator().manual_seed(0), cfg))
