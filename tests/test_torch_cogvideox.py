"""The port's CogVideoX pieces vs the JAX package, on the CPU:

* the schedule: ``ddpm_schedule`` with the SNR shift 3.0 and zero terminal
  SNR, trailing, leading and linspace spacing, timesteps bit for bit (also
  at step counts that do not divide 1000), tables within 1e-6; the DDIM
  steps for v and epsilon within 1e-6; ``dynamic_cfg_table`` bit for bit;
* ``video_positions``, the 2B sin-cos table and the rope tables within
  1e-6; ``init_cogvideox``'s tree;
* ``cogvideox_forward`` on the same fp32 ``cogvideox_tiny`` weights
  (carried by ``params_from_numpy``) in the 2B form (the table), the 5B
  form (3D rope) and the 1.5 form (``patch_t=2`` and the ofs branch) at
  2e-4, the fp32 bound of tests/io/test_backbone_parity.py;
* the 3D VAE: ``tiny_vae3d`` decode dense and tiled at 2e-4; its chunked
  convs and norm against the unchunked ones (1e-6); the causal conv and the
  upsampler leave earlier output frames as they are when later input
  frames change (the norm's statistics span every frame, as diffusers's);
* both converters bit-equal to JAX's in fp32 and bf16 on the state dicts
  of ``tests/torch_ref.py``'s ``CogVideoXRef`` and ``CogVideoXVAEDecoderRef``;
  the port's forward and decode on the converted states against those refs
  at 2e-4; every key of the official 2B, 5B and 1.5-5B inventories read.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.models import cogvideox as jcog
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu.pipelines import base as jbase
from compactfusion_tpu.schedulers import diffusion as jsched
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import cogvideox as tcog
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.pipelines import base as tbase
from compactfusion_tpu_torch.schedulers import diffusion as tsched
from tests import torch_ref
from tests.helpers import rel_err, spice_params
from tests.io.test_real_keymaps import TrackingState

BOUND = 2e-4
TABLE_TOL = 1e-6
SINCOS_FULL_TOL = 4e-6
FIXTURES = Path(__file__).resolve().parent / "io" / "fixtures"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("steps", [50, 48, 7, 4])
def test_cogvideox_schedule_matches_jax(spacing, steps):
    for kw in (dict(snr_shift_scale=3.0, rescale_zero_snr=True), dict(snr_shift_scale=3.0), {}):
        j = jsched.ddpm_schedule(steps, timestep_spacing=spacing, **kw)
        t = tsched.ddpm_schedule(steps, timestep_spacing=spacing, **kw)
        np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
        assert t.timesteps.dtype == torch.int32
        np.testing.assert_allclose(t.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod), rtol=0, atol=TABLE_TOL)
        assert float(t.final_alpha_cumprod) == float(j.final_alpha_cumprod)
    # zero terminal SNR: the last alpha_bar is the clamp floor, the first kept
    z = tsched.ddpm_schedule(steps, snr_shift_scale=3.0, rescale_zero_snr=True)
    assert float(z.alphas_cumprod[-1]) == pytest.approx(1e-12, rel=1e-3)


def test_trailing_timesteps_bit_equal_at_every_step_count():
    """The port takes the trailing grid from numpy's fp32 arange, as jnp's
    is filled; torch's fp32 arange lands one step off at about half the N
    in 1..1000 (the first at N = 48)."""
    for n in (1, 3, 7, 13, 30, 48, 96, 181, 199, 250, 333, 999, 1000):
        want = np.asarray(jnp.round(jnp.arange(1000, 0, -1000 / n)).astype(jnp.int32) - 1)
        np.testing.assert_array_equal(tsched.ddpm_schedule(n, timestep_spacing="trailing").timesteps.numpy(),
                                      want, err_msg=str(n))


@pytest.mark.parametrize("steps", [50, 7])
def test_ddim_steps_and_dynamic_cfg_match_jax(steps):
    kw = dict(snr_shift_scale=3.0, rescale_zero_snr=True, timestep_spacing="trailing")
    js, ts = jsched.ddpm_schedule(steps, **kw), tsched.ddpm_schedule(steps, **kw)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 16)).astype(np.float32)
    for i in (0, 1, steps // 2, steps - 1):
        want = np.asarray(jsched.ddim_step_v(js, jnp.asarray(i), steps, jnp.asarray(x), jnp.asarray(v)))
        got = tsched.ddim_step_v(ts, i, steps, torch.from_numpy(x), torch.from_numpy(v)).numpy()
        assert rel_err(got, want) < TABLE_TOL, i
        want = np.asarray(jsched.ddim_step(js, jnp.asarray(i), steps, jnp.asarray(x), jnp.asarray(v)))
        got = tsched.ddim_step(ts, i, steps, torch.from_numpy(x), torch.from_numpy(v)).numpy()
        assert rel_err(got, want) < TABLE_TOL, i
    # the bf16 sample keeps its dtype
    assert tsched.ddim_step_v(ts, 0, steps, torch.from_numpy(x).bfloat16(), torch.from_numpy(v)).dtype == torch.bfloat16
    for g in (6.0, 3.5):
        want = np.asarray(jbase.dynamic_cfg_table(g, js.timesteps, steps))
        got = tbase.dynamic_cfg_table(g, ts.timesteps, steps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_cfg_combine_with_a_table_entry_promotes_as_jax():
    rng = np.random.default_rng(5)
    eps = rng.standard_normal((4, 6, 8)).astype(np.float32)
    g = jbase.dynamic_cfg_table(6.0, jsched.ddpm_schedule(10, timestep_spacing="trailing").timesteps, 10)[3]
    ej = jnp.asarray(eps, jnp.bfloat16)
    want = np.asarray(jbase.cfg_combine(ej, g, 1))
    got = tbase.cfg_combine(torch.from_numpy(eps).bfloat16(), torch.tensor(float(g)), 1)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tbase.cfg_combine(torch.from_numpy(eps).bfloat16(), 6.0, 1)
    assert plain.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# positions, tables, init
# ---------------------------------------------------------------------------


def test_positions_and_tables_match_jax():
    for f, hp, wp in ((2, 4, 4), (3, 2, 5), (13, 30, 45)):
        np.testing.assert_array_equal(tcog.video_positions(f, hp, wp).numpy(),
                                      np.asarray(jcog.video_positions(f, hp, wp)))
    # 2B: a 2D table over (frames x rows, cols).  The port takes sin and cos
    # of the same fp32 arguments in float64 (one rounding), JAX in fp32: at
    # the full grid's arguments (up to 389 rad) JAX's own error reaches 2e-6
    for dim, f, hp, wp, tol in ((64, 2, 4, 4, TABLE_TOL), (1920, 13, 30, 45, SINCOS_FULL_TOL)):
        want = np.asarray(jcm.sincos_pos_embed_2d(dim, f * hp, wp))
        got = tcm.sincos_pos_embed_2d(dim, f * hp, wp).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for axes, (f, hp, wp) in (((8, 4, 4), (2, 4, 4)), ((16, 24, 24), (13, 30, 45))):
        jc, js = jcm.rope_frequencies(jcog.video_positions(f, hp, wp), axes)
        tc, ts = tcm.rope_frequencies(tcog.video_positions(f, hp, wp), axes)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TABLE_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=TABLE_TOL)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("patch_t", [1, 2])
def test_init_cogvideox_tree_matches_jax(patch_t):
    for rotary in (True, False):
        jm = dataclasses.replace(jcog.cogvideox_tiny(patch_t), use_rotary=rotary)
        tm = dataclasses.replace(tcog.cogvideox_tiny(patch_t), use_rotary=rotary)
        jp = jcog.init_cogvideox(jax.random.PRNGKey(0), jm)
        tp = tcog.init_cogvideox(torch.Generator().manual_seed(0), tm)
        assert _shapes(tp) == _shapes(jp)
    for j, t in ((jcog.cogvideox_2b(), tcog.cogvideox_2b()), (jcog.cogvideox_5b(), tcog.cogvideox_5b()),
                 (jcog.cogvideox_1_5_5b(), tcog.cogvideox_1_5_5b())):
        jd = dataclasses.asdict(j)
        td = dataclasses.asdict(t)
        assert {k: v for k, v in td.items() if k != "dtype"} == {k: v for k, v in jd.items() if k != "dtype"}
        assert (t.head_dim, t.token_in, t.token_out) == (j.head_dim, j.token_in, j.token_out)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

FORMS = {"2b-table": (1, False), "5b-rope": (1, True), "1.5-patch_t2": (2, True)}


@pytest.fixture(scope="module")
def tiny():
    out = {}
    for name, (patch_t, rotary) in FORMS.items():
        jm = dataclasses.replace(jcog.cogvideox_tiny(patch_t), use_rotary=rotary, dtype=jnp.float32)
        tm = dataclasses.replace(tcog.cogvideox_tiny(patch_t), use_rotary=rotary, dtype=torch.float32)
        jp = spice_params(jcog.init_cogvideox(jax.random.PRNGKey(1), jm))
        out[name] = (jm, tm, jp, params_from_numpy(_np_tree(jp)))
    return out


def _fwd_inputs(m, f=2, hp=4, wp=4, b=2, s_txt=6, seed=3):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((b, f * hp * wp, m.token_in)).astype(np.float32)
    txt = rng.standard_normal((b, s_txt, m.text_dim)).astype(np.float32)
    return vid, txt, np.array([44.0, 912.0][:b], np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_cogvideox_forward_matches_jax(tiny, form):
    jm, tm, jp, tp = tiny[form]
    f, hp, wp = 2, 4, 4
    vid, txt, t = _fwd_inputs(jm, f, hp, wp)
    if jm.use_rotary:
        jkw = dict(video_rope=jcm.rope_frequencies(jcog.video_positions(f, hp, wp), jm.axes_dim))
        tkw = dict(video_rope=tcm.rope_frequencies(tcog.video_positions(f, hp, wp), tm.axes_dim))
    else:
        jkw = dict(pos_embed=jcm.sincos_pos_embed_2d(jm.dim, f * hp, wp))
        tkw = dict(pos_embed=tcm.sincos_pos_embed_2d(tm.dim, f * hp, wp))
    want, _ = jcog.cogvideox_forward(jp, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t), jm, **jkw)
    args = (torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), tm)
    got, state = tcog.cogvideox_forward(tp, *args, **tkw)
    assert got.shape == (2, f * hp * wp, tm.token_out) and state == ()
    assert rel_err(got.numpy(), np.asarray(want)) < BOUND
    # per-layer strategy segments: the same function
    segs, _ = tcog.cogvideox_forward(tp, *args, attn=((SingleDeviceAttn(), 1), (SingleDeviceAttn(), 1)),
                                     attn_state=((), ()), **tkw)
    torch.testing.assert_close(segs, got, rtol=0, atol=0)


def test_unported_forward_branches_raise(tiny):
    _, tm, _, tp = tiny["5b-rope"]
    vid, txt, t = (torch.from_numpy(a) for a in _fwd_inputs(tm))
    rope = tcm.rope_frequencies(tcog.video_positions(2, 4, 4), tm.axes_dim)
    # PipeFusion and TP are ported: without this rank's mesh they raise
    with pytest.raises(ValueError, match="mesh"):
        tcog.cogvideox_forward(tp, vid, txt, t, tm, video_rope=rope, pp_stages=2)
    with pytest.raises(ValueError, match="mesh"):
        tcog.cogvideox_forward(tp, vid, txt, t, tm, video_rope=rope, tp_axis="tp")


# ---------------------------------------------------------------------------
# the 3D VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae():
    jv = dataclasses.replace(jvae3d.tiny_vae3d(), dtype=jnp.float32)
    tv = dataclasses.replace(tvae3d.tiny_vae3d(), dtype=torch.float32)
    jp = jvae3d.init_vae3d_decoder(jax.random.PRNGKey(2), jv)
    # spice the zero biases so every term moves the output
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype), jp)
    return jv, tv, jp, params_from_numpy(_np_tree(jp))


def _latents(t=3, h=6, w=6, c=4, seed=9):
    return np.random.default_rng(seed).standard_normal((1, t, h, w, c)).astype(np.float32)


def test_init_vae3d_tree_matches_jax():
    for jv, tv in ((jvae3d.tiny_vae3d(), tvae3d.tiny_vae3d()), (jvae3d.cogvideox_vae(), tvae3d.cogvideox_vae())):
        assert {k: v for k, v in dataclasses.asdict(tv).items() if k != "dtype"} == \
            {k: v for k, v in dataclasses.asdict(jv).items() if k != "dtype"}
    jv, tv = jvae3d.tiny_vae3d(), tvae3d.tiny_vae3d()
    assert _shapes(tvae3d.init_vae3d_decoder(torch.Generator().manual_seed(0), tv)) == \
        _shapes(jvae3d.init_vae3d_decoder(jax.random.PRNGKey(0), jv))


@pytest.mark.parametrize("frames", [3, 2])
def test_vae3d_decode_matches_jax(vae, frames):
    jv, tv, jp, tp = vae
    z = _latents(frames)
    want = np.asarray(jvae3d.vae3d_decode(jp, jnp.asarray(z), jv))
    got = tvae3d.vae3d_decode(tp, torch.from_numpy(z), tv)
    # odd T: (T - 1) * 2 + 1 frames; even T: doubled
    assert got.shape == want.shape == (1, 5 if frames == 3 else 4, 12, 12, 3)
    assert rel_err(got.numpy(), want) < BOUND


def test_vae3d_tiled_decode_matches_jax(vae):
    jv, tv, jp, tp = vae
    z = _latents(3, 8, 10)
    jt = dataclasses.replace(jv, use_tiling=True, tile_latent_size=4)
    tt = dataclasses.replace(tv, use_tiling=True, tile_latent_size=4)
    want = np.asarray(jvae3d.vae3d_decode(jp, jnp.asarray(z), jt))
    got = tvae3d.vae3d_decode(tp, torch.from_numpy(z), tt).numpy()
    dense = tvae3d.vae3d_decode(tp, torch.from_numpy(z), tv).numpy()
    assert got.shape == want.shape == dense.shape == (1, 5, 16, 20, 3)
    assert rel_err(got, want) < BOUND
    assert rel_err(got, dense) > 1e-3  # the tiles see less context than the dense decode


def test_vae3d_chunked_convs_and_norm_match_unchunked(vae, monkeypatch):
    _, tv, _, tp = vae
    z = torch.from_numpy(_latents(3, 6, 6))
    whole = tvae3d.vae3d_decode(tp, z, tv)
    # chunks of one to a few frames at every level
    monkeypatch.setattr(tvae3d, "CONV_CHUNK_ELEMS", 1500)
    monkeypatch.setattr(tvae3d, "NORM_CHUNK_ELEMS", 900)
    assert len(tvae3d._frame_chunks(5, 12 * 12 * 8, tvae3d.CONV_CHUNK_ELEMS)) == 5
    chunked = tvae3d.vae3d_decode(tp, z, tv)
    assert rel_err(chunked.numpy(), whole.numpy()) < TABLE_TOL
    # each piece alone: the causal and the plain conv, the norm, the upsampler
    # up block 1's first resnet takes 16 channels to 8; up block 0 upsamples 16
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 5, 12, 12, 16)).astype(np.float32))
    res = tp["up"][1]["resnets"][0]
    for fn in (lambda: tvae3d._conv3(res["conv1"], x, causal=True),
               lambda: tvae3d._conv3(res["norm1"]["conv_y"], x[..., :4], causal=False),
               lambda: tvae3d._spatial_norm(res["norm1"], x, z, 4, silu=True),
               lambda: tvae3d._upsample3(tp["up"][0]["upsample_conv"], x, True)):
        chunked = fn()
        monkeypatch.setattr(tvae3d, "CONV_CHUNK_ELEMS", 1 << 30)
        monkeypatch.setattr(tvae3d, "NORM_CHUNK_ELEMS", 1 << 27)
        plain = fn()
        monkeypatch.setattr(tvae3d, "CONV_CHUNK_ELEMS", 1500)
        monkeypatch.setattr(tvae3d, "NORM_CHUNK_ELEMS", 900)
        assert chunked.shape == plain.shape
        assert rel_err(chunked.numpy(), plain.numpy()) < TABLE_TOL


def test_vae3d_causal_conv_and_upsampler_keep_earlier_frames(vae, monkeypatch):
    _, _, _, tp = vae
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 6, 16)).astype(np.float32))
    late = x.clone()
    late[:, 3:] += torch.from_numpy(rng.standard_normal((1, 2, 6, 6, 16)).astype(np.float32))
    conv = tp["up"][1]["resnets"][0]["conv1"]
    for chunk in (1 << 30, 700):
        monkeypatch.setattr(tvae3d, "CONV_CHUNK_ELEMS", chunk)
        a, b = tvae3d._conv3(conv, x, causal=True), tvae3d._conv3(conv, late, causal=True)
        torch.testing.assert_close(a[:, :3], b[:, :3], rtol=0, atol=0)
        assert not torch.equal(a[:, 3:], b[:, 3:])
    # T = 5 -> 9: output frames 0..4 read input frames 0..2
    up = tp["up"][0]["upsample_conv"]
    a, b = tvae3d._upsample3(up, x, True), tvae3d._upsample3(up, late, True)
    assert a.shape[1] == 9
    torch.testing.assert_close(a[:, :5], b[:, :5], rtol=0, atol=0)
    assert tvae3d._upsample_frames(5, True) == [0, 1, 1, 2, 2, 3, 3, 4, 4]
    assert tvae3d._upsample_frames(4, True) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert tvae3d._zq_frames(13, 49) == [0] + [1 + i // 4 for i in range(48)]


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------

REF_TINY = dict(dim=64, depth=2, heads=4, patch=2, in_channels=16, text_dim=32, time_embed_dim=32, axes_dim=(8, 4, 4))


def _ref_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _cog_ref(patch_t):
    torch.manual_seed(12 + patch_t)
    return torch_ref.CogVideoXRef(**REF_TINY, patch_t=patch_t).eval()


def _vae_ref():
    torch.manual_seed(8)
    return torch_ref.CogVideoXVAEDecoderRef(latent_channels=4, out_channels=3, block_out_channels=(8, 16),
                                            layers_per_block=1, groups=4, temporal_compress_levels=1).eval()


def _assert_trees_equal(tp, jp, dtype):
    jl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), jp))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jl):
        assert t.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(t.float().numpy(), j, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("patch_t", [1, 2])
def test_convert_cogvideox_matches_jax_bit_for_bit(patch_t, dtype):
    state = _ref_state(_cog_ref(patch_t))
    jm = dataclasses.replace(jcog.cogvideox_tiny(patch_t), dtype=getattr(jnp, dtype))
    tm = dataclasses.replace(tcog.cogvideox_tiny(patch_t), dtype=getattr(torch, dtype))
    _assert_trees_equal(thf.convert_cogvideox(state, tm), jhf.convert_cogvideox(state, jm), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_vae3d_decoder_matches_jax_bit_for_bit(dtype):
    state = _ref_state(_vae_ref())
    jv = dataclasses.replace(jvae3d.tiny_vae3d(), dtype=getattr(jnp, dtype))
    tv = dataclasses.replace(tvae3d.tiny_vae3d(), dtype=getattr(torch, dtype))
    tracked = TrackingState({k: v.shape for k, v in state.items()})
    tracked.update(state)
    _assert_trees_equal(thf.convert_vae3d_decoder(tracked, tv), jhf.convert_vae3d_decoder(state, jv), dtype)
    assert set(tracked) == tracked.read


@pytest.mark.parametrize("patch_t", [1, 2])
def test_port_forward_on_converted_weights_matches_cogvideox_ref(patch_t):
    ref = _cog_ref(patch_t)
    cfg = dataclasses.replace(tcog.cogvideox_tiny(patch_t), dtype=torch.float32)
    params = thf.convert_cogvideox(_ref_state(ref), cfg)
    ft, hp, wp = 2, 4, 4
    vid, txt, t = _fwd_inputs(cfg, ft, hp, wp, seed=13)
    pos = tcog.video_positions(ft, hp, wp)
    with torch.no_grad():
        want = ref(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), pos).numpy()
        got, _ = tcog.cogvideox_forward(params, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t),
                                        cfg, video_rope=tcm.rope_frequencies(pos, cfg.axes_dim))
    if patch_t > 1:
        # the ref's features are (C, p_t, p, p)-ordered, the model's (p_t, p, p, C)
        b, s, _ = want.shape
        want = want.reshape(b, s, 16, 2, 2, 2).transpose(0, 1, 3, 4, 5, 2).reshape(b, s, -1)
    assert rel_err(got.numpy(), want) < BOUND


def test_port_vae3d_on_converted_weights_matches_ref():
    ref = _vae_ref()
    cfg = dataclasses.replace(tvae3d.tiny_vae3d(), scaling_factor=1.0, dtype=torch.float32)
    params = thf.convert_vae3d_decoder(_ref_state(ref), cfg)
    z = np.random.default_rng(9).standard_normal((1, 4, 3, 6, 6)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(z)).numpy()  # (B, 3, T, H, W)
    got = tvae3d.vae3d_decode(params, torch.from_numpy(z).permute(0, 2, 3, 4, 1), cfg)
    assert got.shape == (1, 5, 12, 12, 3)
    assert rel_err(got.permute(0, 4, 1, 2, 3).numpy(), want) < BOUND


def _scaled(name, n):
    """The inventory's widths over 32 (1920 -> 60, 3072 -> 96, T5's 4096 ->
    128, the 512 of the time embedding -> 16, the head dim 64 -> 2); the
    packed token widths (64, 128), the 16 latent channels and the patch stay."""
    if name.endswith(("norm_q.weight", "norm_q.bias", "norm_k.weight", "norm_k.bias")):
        return n // 32
    return n // 32 if n >= 512 and n % 32 == 0 else n


@pytest.mark.parametrize("variant", ["cogvideox-2b", "cogvideox-5b", "cogvideox1.5-5b"])
def test_convert_cogvideox_reads_every_key_of_the_official_inventory(variant):
    lines = [ln.split() for ln in (FIXTURES / f"{variant}.keys.txt").read_text().splitlines()
             if ln and not ln.startswith("#")]
    shapes = {name: tuple(_scaled(name, int(d)) for d in dims.split(",")) for name, dims in lines}
    base = {"cogvideox-2b": tcog.cogvideox_2b, "cogvideox-5b": tcog.cogvideox_5b,
            "cogvideox1.5-5b": tcog.cogvideox_1_5_5b}[variant]()
    cfg = dataclasses.replace(base, dim=base.dim // 32, text_dim=128, time_embed_dim=16, dtype=torch.float32)
    assert cfg.head_dim == 2 and cfg.depth in (30, 42)
    state = TrackingState(shapes)
    params = thf.convert_cogvideox(state, cfg)
    # 2B's checkpoint stores its 3D sin-cos table at the 49 x 480 x 720
    # sample geometry; the JAX package (and so the port) builds a 2D table
    # for the request's own grid and never reads it (ROADMAP's divergences)
    unread = set(state) - state.read
    assert unread == ({"patch_embed.pos_embedding"} if variant == "cogvideox-2b" else set()), sorted(unread)[:10]
    init = tcog.init_cogvideox(torch.Generator().manual_seed(0), cfg)
    assert _shapes(params) == _shapes(init)
