"""The port's HunyuanDiT pieces vs the JAX package on the same fp32
``hunyuandit_tiny`` weights (carried by ``params_from_numpy``, modulation
biases spiced, the learned text padding and pooler table drawn):
``hunyuandit_positions`` (the column coordinate first) and their rope
tables on a non-square grid at 1e-6; ``init_hunyuandit``'s tree;
``hunyuandit_condition`` and the attention pool, ``hunyuandit_forward``
with a padded text mask, and the forward on a non-square grid (where a
transposed rope grid would give another output), each at 2e-4 relative
(the fp32 bound of tests/io/test_backbone_parity.py); and head dim 88's
kernel plan: the register body at DP 96, within a CTA's shared memory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import hunyuandit as jhy
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import hunyuandit as thy
from tests.helpers import rel_err, spice_params

BOUND = 2e-4
HELPER_TOL = 1e-6


@pytest.fixture(scope="module")
def tiny():
    jm = dataclasses.replace(jhy.hunyuandit_tiny(), dtype=jnp.float32)
    tm = dataclasses.replace(thy.hunyuandit_tiny(), dtype=torch.float32)
    jp = spice_params(jhy.init_hunyuandit(jax.random.PRNGKey(0), jm))
    rng = np.random.default_rng(9)
    # the zero-initialised learned tables, drawn so that they count
    jp = dict(jp, text_pad=jnp.asarray(rng.standard_normal(jp["text_pad"].shape), jnp.float32),
              pooler=dict(jp["pooler"], pos=jnp.asarray(rng.standard_normal(jp["pooler"]["pos"].shape) * 0.3,
                                                         jnp.float32)))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("grid", [(4, 6), (3, 5), (64, 64)])
def test_positions_and_rope_match_jax(grid):
    want = np.asarray(jhy.hunyuandit_positions(*grid))
    got = thy.hunyuandit_positions(*grid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].tolist() == [1, 0]  # the second token of a row: column 1 first
    for axes in ((8, 8), (44, 44)):
        jc, js = jcm.rope_frequencies(jnp.asarray(want), axes)
        tc, ts = tcm.rope_frequencies(got, axes)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=HELPER_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=HELPER_TOL)


def test_init_hunyuandit_tree_matches_jax():
    jm, tm = jhy.hunyuandit_tiny(), thy.hunyuandit_tiny()
    jp = jax.eval_shape(lambda k: jhy.init_hunyuandit(k, jm), jax.random.PRNGKey(0))
    tp = thy.init_hunyuandit(torch.Generator().manual_seed(0), tm)
    shapes_j = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    shapes_t = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert shapes_t == shapes_j
    v12 = thy.hunyuandit_v12()
    assert (v12.depth, v12.dim, v12.heads, v12.head_dim, v12.ffn_hidden, v12.rope_axes) == \
        (40, 1408, 16, 88, 6144, (44, 44))
    with pytest.raises(ValueError, match="even"):
        thy.init_hunyuandit(torch.Generator(), dataclasses.replace(tm, depth=3))


def test_condition_and_attention_pool_match_jax(tiny):
    jm, tm, jp, tp = tiny
    rng = np.random.default_rng(4)
    b = 2
    clip = rng.standard_normal((b, jm.text_len, jm.text_dim)).astype(np.float32)
    t5 = rng.standard_normal((b, jm.text_len_t5, jm.t5_dim)).astype(np.float32)
    clip_mask = np.ones((b, jm.text_len), bool)
    clip_mask[1, 4:] = False
    t5_mask = np.ones((b, jm.text_len_t5), bool)
    t5_mask[0, 5:] = False
    pool_want = jhy._attention_pool(jp["pooler"], jnp.asarray(t5))
    pool_got = thy._attention_pool(tp["pooler"], torch.from_numpy(t5))
    assert rel_err(pool_got.numpy(), pool_want) < BOUND
    for masks in ((clip_mask, t5_mask), (None, None)):
        jt, je = jhy.hunyuandit_condition(jp, jnp.asarray(clip), jnp.asarray(t5),
                                          *(None if m is None else jnp.asarray(m) for m in masks), jm)
        tt, te = thy.hunyuandit_condition(tp, torch.from_numpy(clip), torch.from_numpy(t5),
                                          *(None if m is None else torch.from_numpy(m) for m in masks), tm)
        assert tt.shape == jt.shape == (b, jm.text_len + jm.text_len_t5, jm.text_dim)
        assert rel_err(tt.numpy(), jt) < BOUND and rel_err(te.numpy(), je) < BOUND
    # a masked row is the learned padding row
    np.testing.assert_array_equal(tt.numpy()[0, 0], np.asarray(jt)[0, 0])


def _forward_pair(tiny, grid, text_mask=None, extra=False, seed=3):
    jm, tm, jp, tp = tiny
    rng = np.random.default_rng(seed)
    hp, wp = grid
    b, s_txt = 2, 7
    x = rng.standard_normal((b, hp * wp, jm.patch ** 2 * jm.in_channels)).astype(np.float32)
    text = rng.standard_normal((b, s_txt, jm.text_dim)).astype(np.float32)
    t = np.array([900.0, 41.0], np.float32)
    temb_extra = rng.standard_normal((b, jm.dim)).astype(np.float32) if extra else None
    jrope = jcm.rope_frequencies(jhy.hunyuandit_positions(hp, wp), jm.rope_axes)
    trope = tcm.rope_frequencies(thy.hunyuandit_positions(hp, wp), tm.rope_axes)
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    want, _, _ = jhy.hunyuandit_forward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), jm, rope=jrope,
                                        text_mask=opt(text_mask, jnp.asarray),
                                        temb_extra=opt(temb_extra, jnp.asarray))
    got, sd, su = thy.hunyuandit_forward(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), tm,
                                         rope=trope, text_mask=opt(text_mask, torch.from_numpy),
                                         temb_extra=opt(temb_extra, torch.from_numpy))
    assert got.shape == want.shape == (b, hp * wp, jm.patch ** 2 * jm.out_channels)
    assert sd == () and su == ()
    return got.numpy(), np.asarray(want), (tp, tm, x, t, text)


def test_forward_matches_jax_with_a_padded_mask(tiny):
    mask = np.ones((2, 7), bool)
    mask[1, 3:] = False
    got, want, _ = _forward_pair(tiny, (4, 4), text_mask=mask, extra=True)
    assert rel_err(got, want) < BOUND


def test_forward_matches_jax_on_a_non_square_grid(tiny):
    """On a 3 x 5 grid the rope puts the column first; the same tokens
    under a transposed position table give another output."""
    got, want, (tp, tm, x, t, text) = _forward_pair(tiny, (3, 5))
    assert rel_err(got, want) < BOUND
    wrong = tcm.rope_frequencies(tcm.patch_positions_2d(3, 5), tm.rope_axes)
    other, _, _ = thy.hunyuandit_forward(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), tm,
                                         rope=wrong)
    assert rel_err(other.numpy(), want) > 100 * BOUND


def test_forward_raises_without_a_mesh(tiny):
    _, tm, _, tp = tiny
    rope = tcm.rope_frequencies(thy.hunyuandit_positions(2, 2), tm.rope_axes)
    args = (torch.zeros(1, 4, 16), torch.full((1,), 5.0), torch.zeros(1, 3, 32), tm)
    for kw in (dict(pp_stages=2), dict(tp_axis="tp")):
        with pytest.raises(ValueError, match="mesh"):
            thy.hunyuandit_forward(tp, *args, rope=rope, **kw)


@pytest.mark.parametrize("b,h,sq", [(2, 16, 4096), (2, 8, 4096), (2, 16, 2048), (2, 16, 1024), (1, 16, 4096)])
def test_head_dim_88_takes_the_register_body_at_dp_96(b, h, sq):
    """HunyuanDiT's d = 88 (self-attention, its Ulysses-2, ring-2 and patch
    shapes) takes the register body padded to DP 96, a built plan whose
    shared memory (the C layout's statements, ``ops/flash.py::reg_layout``)
    fits a CTA in bf16 and fp32; the ring kernel takes the same plan."""
    from compactfusion_tpu_torch.ops import flash

    for elem in (2, 4):
        plan = flash.flash_plan(b, h, sq, 88, elem=elem)
        assert plan[:2] == ("flash_reg_tile", 96) and (96, plan[2]) in flash.REG_BUILT
        assert flash.launch_plan(b, h, sq, 88, {2: torch.bfloat16, 4: torch.float32}[elem])[0] == plan
        assert flash.reg_layout(96, plan[2], elem)["bytes"] <= flash.SMEM_MAX
    assert all(flash.reg_layout(96, w, e)["bytes"] <= flash.SMEM_MAX for w in flash.REG_WARPS for e in (2, 4))
