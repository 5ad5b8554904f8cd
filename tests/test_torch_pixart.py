"""Port's PixArt backbone, scheduler and VAE decoder vs the JAX package.

Both sides run in fp32 (``dataclasses.replace(dtype=float32)``) on the same
weights, carried over with ``params_from_numpy``.  Bound 2e-4 relative: the
fp32 bound of tests/io/test_backbone_parity.py; the two frameworks differ
only in fp32 summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import pixart as jpix
from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu.schedulers import diffusion as jdiff
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.schedulers import diffusion as tdiff
from tests.helpers import rel_err, spice_params

BOUND = 2e-4


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jpix.pixart_tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    jparams = spice_params(jpix.init_pixart(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jparams, _to_torch(jparams)


def test_pixart_forward_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(0)
    b, s, st = 2, 16, 7
    x = rng.standard_normal((b, s, 16)).astype(np.float32)
    t = np.asarray([999.0, 421.0], np.float32)
    text = rng.standard_normal((b, st, jcfg.text_dim)).astype(np.float32)
    mask = np.ones((b, st), bool)
    mask[1, 5:] = False
    pos = jcm.sincos_pos_embed_2d(jcfg.dim, 4, 4, base_size=jcfg.base_size)
    tpos = tcm.sincos_pos_embed_2d(tcfg.dim, 4, 4, base_size=tcfg.base_size)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(pos), rtol=0, atol=1e-6)

    ref, _ = jpix.pixart_forward(jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                                 jcfg, pos_embed=pos, text_mask=jnp.asarray(mask))
    out, state = tpix.pixart_forward(tparams, torch.from_numpy(x), torch.from_numpy(t),
                                     torch.from_numpy(text), tcfg, pos_embed=tpos,
                                     text_mask=torch.from_numpy(mask))
    assert out.shape == (b, s, 32) and state == ()
    assert rel_err(out.numpy(), ref) < BOUND

    # the hoisted text K/V path gives the same forward
    kv = tpix.precompute_text_kv(tparams, torch.from_numpy(text))
    jkv = jpix.precompute_text_kv(jparams, jnp.asarray(text))
    assert kv.shape == (jcfg.depth, b, st, 2 * jcfg.dim)
    assert rel_err(kv.numpy(), jkv) < BOUND
    out_kv, _ = tpix.pixart_forward(tparams, torch.from_numpy(x), torch.from_numpy(t), None,
                                    tcfg, pos_embed=tpos, text_mask=torch.from_numpy(mask),
                                    text_kv=kv)
    assert rel_err(out_kv.numpy(), ref) < BOUND


def test_unported_branches_raise(tiny):
    """PipeFusion and TP are ported and raise without this rank's mesh; the
    cache accelerators are ported and refuse a stateful attention strategy;
    per-layer plans are ported, and segments that do not cover the blocks
    are refused."""
    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig, init_cache_state

    _, tcfg, _, tparams = tiny
    x = torch.zeros(1, 16, 16)
    kw = dict(pos_embed=torch.zeros(16, tcfg.dim))
    with pytest.raises(ValueError, match="mesh"):
        tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                            pp_stages=2, **kw)
    with pytest.raises(ValueError, match="mesh"):
        tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                            tp_axis="tp", **kw)
    # the cache's block 0 and the rest are not one stage's blocks
    with pytest.raises(ValueError, match="PipeFusion"):
        tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg, pp_stages=2,
                            mesh=object(), cache_cfg=CacheAccelConfig(mode="teacache"),
                            cache_state=init_cache_state((1, 16, tcfg.dim), (1, 16, tcfg.dim), torch.float32),
                            **kw)
    cache = dict(cache_cfg=CacheAccelConfig(mode="teacache"),
                 cache_state=init_cache_state((1, 16, tcfg.dim), (1, 16, tcfg.dim), torch.float32))
    with pytest.raises(ValueError):
        tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                            attn_state={"residual": torch.zeros(1)}, **cache, **kw)
    assert len(tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                                   **cache, **kw)) == 3
    with pytest.raises(ValueError):
        tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                            attn=((SingleDeviceAttn(), 1),), attn_state=((),), **kw)
    out, state = tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg,
                                     attn=((SingleDeviceAttn(), 1), (SingleDeviceAttn(), 1)),
                                     attn_state=((), ()), **kw)
    ref, _ = tpix.pixart_forward(tparams, x, torch.zeros(1), torch.zeros(1, 3, 32), tcfg, **kw)
    assert state == ((), ()) and torch.equal(out, ref)


def test_patchify_roundtrip_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 6, 4)).astype(np.float32)
    p = tcm.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jcm.patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tcm.unpatchify(p, 2, 4, 3, 4).numpy(), x)


@pytest.mark.parametrize("num_steps", [4, 20])
def test_dpm_solver_matches_jax(num_steps):
    jsched = jdiff.ddpm_schedule(num_steps, timestep_spacing="linspace")
    tsched = tdiff.ddpm_schedule(num_steps, timestep_spacing="linspace")
    np.testing.assert_array_equal(tsched.timesteps.numpy(), np.asarray(jsched.timesteps))
    np.testing.assert_allclose(tsched.alphas_cumprod.numpy(), np.asarray(jsched.alphas_cumprod),
                               rtol=1e-6)
    rng = np.random.default_rng(num_steps)
    x = rng.standard_normal((1, 16, 16)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jst, tst = jdiff.dpm_init_state(x.shape), tdiff.dpm_init_state(x.shape)
    for i in range(num_steps):
        eps = (0.5 * x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        jx, jst = jdiff.dpm_step(jsched, i, num_steps, jx, jnp.asarray(eps), jst)
        tx, tst = tdiff.dpm_step(tsched, i, num_steps, tx, torch.from_numpy(eps), tst)
        assert rel_err(tx.numpy(), jx) < BOUND, i


def test_tiny_vae_decode_matches_jax():
    jcfg = dataclasses.replace(jvae.tiny_vae(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    jparams = jvae.init_vae_decoder(jax.random.PRNGKey(1), jcfg)
    lat = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.5
    ref = jvae.vae_decode(jparams, jnp.asarray(lat), jcfg)
    out = tvae.vae_decode(_to_torch(jparams), torch.from_numpy(lat), tcfg)
    assert out.shape == (2, 16, 16, 3)
    assert rel_err(out.numpy(), ref) < BOUND
    # the tiled decode: a latent within one tile passes through bit for bit;
    # 4-px tiles hold JAX's tiled decode
    assert torch.equal(tvae.vae_decode(_to_torch(jparams), torch.from_numpy(lat),
                                       dataclasses.replace(tcfg, use_tiling=True)), out)
    small = dict(use_tiling=True, tile_latent_size=4)
    tiled = tvae.vae_decode(_to_torch(jparams), torch.from_numpy(lat), dataclasses.replace(tcfg, **small))
    want = jax.jit(jvae.vae_decode, static_argnums=2)(jparams, jnp.asarray(lat), dataclasses.replace(jcfg, **small))
    assert rel_err(tiled.numpy(), want) < BOUND


def test_torch_inits_build_the_jax_tree():
    """The port's own inits (torch.Generator draws) give the JAX trees'
    keys, shapes and dtypes."""
    jcfg, tcfg = jpix.pixart_tiny(), tpix.pixart_tiny()
    jp = jax.eval_shape(lambda k: jpix.init_pixart(k, jcfg), jax.random.PRNGKey(0))
    tp = tpix.init_pixart(torch.Generator().manual_seed(0), tcfg)
    jv = jax.eval_shape(lambda k: jvae.init_vae_decoder(k, jvae.tiny_vae()), jax.random.PRNGKey(0))
    tv = tvae.init_vae_decoder(torch.Generator().manual_seed(0), tvae.tiny_vae())
    for j, t in ((jp, tp), (jv, tv)):
        jl, jdef = jax.tree_util.tree_flatten(j)
        tl, tdef = jax.tree_util.tree_flatten(t)
        assert jdef == tdef
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).replace("torch.", "")
    w = tp["blocks"]["attn_qkv"]["w"].float()
    # truncated normal: |w| <= 2 * 0.02, up to bf16 rounding; std ~0.88 * 0.02
    assert w.abs().max() <= 0.04 * (1 + 2**-8) and 0.01 < w.std() < 0.02


def test_cross_attn_bool_mask_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 10, 2, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    mask = np.ones((2, 1, 1, 6), bool)
    mask[0, ..., 2:] = False
    ref = jpix._cross_attn(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    out = tpix._cross_attn(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask))
    assert rel_err(out.numpy(), ref) < BOUND


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("beta", ["scaled_linear", "linear"])
def test_schedule_tables_match_jax(spacing, beta):
    j = jdiff.ddpm_schedule(20, beta_schedule=beta, timestep_spacing=spacing)
    t = tdiff.ddpm_schedule(20, beta_schedule=beta, timestep_spacing=spacing)
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    np.testing.assert_allclose(t.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod), rtol=1e-6)
    assert float(t.final_alpha_cumprod) == float(j.final_alpha_cumprod)


def test_unknown_timestep_spacing_is_a_value_error_in_both_packages():
    """An unknown spacing is a caller's error, in the port as in JAX."""
    for schedule in (jdiff.ddpm_schedule, tdiff.ddpm_schedule):
        with pytest.raises(ValueError, match="unknown timestep spacing uniform"):
            schedule(20, timestep_spacing="uniform")


def test_sincos_table_is_float64_rounded_once():
    """PixArt-512's positional table (1024 x 1152): the sin and cos of the
    JAX package's fp32 arguments, evaluated in double precision and rounded
    to fp32 once (Python's ``math`` on sampled entries), the same bits
    whatever torch's thread count (a pipeline's requests and a ring's ranks
    must see one table), and within 1e-6 of the JAX package's fp32 table."""
    import math

    table = tcm.sincos_pos_embed_2d(1152, 32, 32, base_size=32)
    threads = torch.get_num_threads()
    try:
        for n in (1, 3):
            torch.set_num_threads(n)
            assert torch.equal(tcm.sincos_pos_embed_2d(1152, 32, 32, base_size=32), table)
    finally:
        torch.set_num_threads(threads)
    omega = (1.0 / (10000.0 ** (torch.arange(288, dtype=torch.float32) / 288.0))).numpy()
    for i, j in np.random.default_rng(0).integers(0, (1024, 1152), size=(200, 2)):
        row, col = divmod(int(i), 32)
        pos, k = (col if j < 576 else row), int(j) % 576
        x = float(np.float32(pos) * omega[k % 288])
        assert table[i, j].item() == np.float32(math.sin(x) if k < 288 else math.cos(x))
    np.testing.assert_allclose(table.numpy(), np.asarray(jcm.sincos_pos_embed_2d(1152, 32, 32, base_size=32)),
                               rtol=0, atol=1e-6)
