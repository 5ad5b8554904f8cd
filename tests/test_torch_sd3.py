"""The port's SD3 pieces vs the JAX package: the center-cropped sin-cos
table (the sin and cos of JAX's fp32 arguments rounded once from double
precision, within 1e-6 relative of JAX's fp32 table: elementwise the two
differ by up to 1.9e-6 at SD3-medium's arguments near 42 rad, where XLA's
fp32 sine is that far from the exact one), the ``init_sd3`` tree, ``sd3_forward`` on the same fp32
``sd3_tiny`` weights (carried by ``params_from_numpy``, modulation biases
spiced) with the per-head qk RMSNorm on and off, at 2e-4 relative (the fp32
bound of tests/io/test_backbone_parity.py), and ``sd3_vae``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import sd3 as jsd3
from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import sd3 as tsd3
from compactfusion_tpu_torch.models import vae as tvae
from tests.helpers import rel_err, spice_params

BOUND = 2e-4
HELPER_TOL = 1e-6


@pytest.mark.parametrize("args", [(1536, 64, 64, 192, 64), (1536, 128, 96, 192, 64), (64, 4, 8, 16, 4),
                                  (64, 5, 3, 16, 4, 2.0)])
def test_cropped_pos_embed_matches_jax(args):
    import math

    want = np.asarray(jcm.cropped_pos_embed_2d(*args))
    got = tcm.cropped_pos_embed_2d(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape == (args[1] * args[2], args[0])
    assert rel_err(got.numpy(), want) < HELPER_TOL
    dim, hp, wp, max_size, base = args[:5]
    scale = args[5] if len(args) > 5 else 1.0
    coords = np.arange(max_size, dtype=np.float32) / np.float32(max_size / base) / np.float32(scale)
    half = dim // 2
    omega = (1.0 / (10000.0 ** (torch.arange(half // 2, dtype=torch.float32) / (half / 2.0)))).numpy()
    for i, j in np.random.default_rng(0).integers(0, (hp * wp, dim), size=(200, 2)):
        row, col = divmod(int(i), wp)
        pos = coords[(max_size - wp) // 2 + col] if j < half else coords[(max_size - hp) // 2 + row]
        k = int(j) % half
        x = float(np.float32(pos) * omega[k % (half // 2)])
        assert got[i, j].item() == np.float32(math.sin(x) if k < half // 2 else math.cos(x))


def _tiny(qk_norm):
    jm = dataclasses.replace(jsd3.sd3_tiny(), dtype=jnp.float32, qk_norm=qk_norm)
    tm = dataclasses.replace(tsd3.sd3_tiny(), dtype=torch.float32, qk_norm=qk_norm)
    jp = spice_params(jsd3.init_sd3(jax.random.PRNGKey(0), jm))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("qk_norm", [True, False])
def test_init_sd3_tree_matches_jax(qk_norm):
    jm = dataclasses.replace(jsd3.sd3_tiny(), qk_norm=qk_norm)
    tm = dataclasses.replace(tsd3.sd3_tiny(), qk_norm=qk_norm)
    jp = jax.eval_shape(lambda k: jsd3.init_sd3(k, jm), jax.random.PRNGKey(0))
    tp = tsd3.init_sd3(torch.Generator().manual_seed(0), tm)
    shapes_j = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    shapes_t = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert shapes_t == shapes_j
    assert not tp["blocks"]["img_mod"]["b"].any() and tp["blocks"]["img_qkv"]["w"].std() > 0
    assert tsd3.sd3_medium() == tsd3.SD3Config() and tsd3.sd3_medium().head_dim == 64


@pytest.mark.parametrize("qk_norm", [True, False])
def test_sd3_forward_matches_jax(qk_norm):
    jm, tm, jp, tp = _tiny(qk_norm)
    rng = np.random.default_rng(3)
    hp, wp, s_txt, b = 4, 6, 7, 2
    img = rng.standard_normal((b, hp * wp, jm.patch ** 2 * jm.in_channels)).astype(np.float32)
    txt = rng.standard_normal((b, s_txt, jm.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((b, jm.pooled_dim)).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    jpos = jcm.cropped_pos_embed_2d(jm.dim, hp, wp, jm.pos_embed_max_size, jm.base_size)
    want, _ = jsd3.sd3_forward(jp, *map(jnp.asarray, (img, txt, pooled, t)), jm, pos_embed=jpos)
    tpos = tcm.cropped_pos_embed_2d(tm.dim, hp, wp, tm.pos_embed_max_size, tm.base_size)
    got, st = tsd3.sd3_forward(tp, *map(torch.from_numpy, (img, txt, pooled, t)), tm, pos_embed=tpos)
    assert got.shape == want.shape == img.shape and st == ()
    assert rel_err(got.numpy(), want) < BOUND


def test_sd3_forward_raises_without_a_mesh():
    _, tm, _, tp = _tiny(True)
    args = (torch.zeros(1, 4, 16), torch.zeros(1, 3, 32), torch.zeros(1, 16), torch.full((1,), 5.0), tm)
    pos = torch.zeros(4, tm.dim)
    for kw in (dict(pp_stages=2), dict(tp_axis="tp")):
        with pytest.raises(ValueError, match="mesh"):
            tsd3.sd3_forward(tp, *args, pos_embed=pos, **kw)


def test_sd3_vae_matches_jax():
    j, t = jvae.sd3_vae(), tvae.sd3_vae()
    assert (t.latent_channels, t.scaling_factor, t.shift_factor) == (j.latent_channels, j.scaling_factor,
                                                                       j.shift_factor) == (16, 1.5305, 0.0609)
