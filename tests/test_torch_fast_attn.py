"""The port's DiTFastAttn vs the JAX package: the seven method branches,
calibration losses, plan selection and rewriting, plan files, and the whole
PixArt slice with a plan (pixart_tiny + tiny_vae, fp32, 4 steps, CFG,
window 4).

Tolerances, each with its reason:

* fp32 branches: 1e-5 absolute; the two frameworks differ only in fp32
  summation order and exp/log rounding.
* bf16 branches: one bf16 ulp of the tensor's largest magnitude.  Both round
  the probabilities to bf16 before the PV product; exp/logsumexp differ in
  the last fp32 bits, so a probability may round to its bf16 neighbour and
  move the output by about one ulp at the output's scale.  Each branch is
  run on the same state on both sides, so these differences do not chain.
* Calibration losses: 1e-5 relative (fp32 norms of the same outputs).
* The pipeline: 2e-4 relative on the latents, the fp32 backbone bound of
  tests/test_torch_pipeline.py; the all-FULL plan equals the port's lossless
  run bit for bit (``optimize_plan`` turns every FULL into FULL_NO_RESIDUAL,
  the same attention call).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.cache import fast_attn as jfa
from compactfusion_tpu.models.pixart import init_pixart, pixart_tiny
from compactfusion_tpu.models.vae import init_vae_decoder, tiny_vae
from compactfusion_tpu.config import ParallelConfig as JParallel
from compactfusion_tpu.parallel.mesh import make_mesh
from compactfusion_tpu.pipelines.base import prepare_latents as jprepare_latents
from compactfusion_tpu.pipelines.pixart import PixArtPipeline as JPipeline
from compactfusion_tpu.pipelines.pixart import PixArtPipelineConfig as JPipelineConfig
from compactfusion_tpu_torch.cache import fast_attn as tfa
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import pixart as tpix
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig
from tests.helpers import rel_err, spice_params

F = tfa.FastAttnMethod
STEPS = 4
WINDOW = 4
BOUND = 2e-4

# every branch once, each CFG variant after a state its plain twin left
CHAIN = [F.FULL_ATTN, F.RESIDUAL_WINDOW_ATTN, F.OUTPUT_SHARE, F.FULL_ATTN_CFG_SHARE,
         F.RESIDUAL_WINDOW_ATTN_CFG_SHARE, F.OUTPUT_SHARE, F.RESIDUAL_WINDOW_ATTN,
         F.FULL_ATTN_NO_RESIDUAL, F.FULL_ATTN_CFG_SHARE_NO_RESIDUAL, F.RESIDUAL_WINDOW_ATTN]


def _bf16_ulp(x):
    """One bf16 ulp at |x| (bf16 keeps 16 fewer mantissa bits than fp32)."""
    return np.spacing(np.float32(abs(x))) * 2.0**16


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    else:
        tol = _bf16_ulp(max(np.abs(a).max(), np.abs(b).max()))
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def test_method_values_match_jax():
    assert [(m.name, m.value) for m in jfa.FastAttnMethod] == [(m.name, m.value) for m in F]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cfg_batched", [True, False])
def test_branches_match_jax_on_the_same_state(dtype, cfg_batched):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    b, s, h, d = 2, 32, 4, 16
    rng = np.random.default_rng(11)
    jimpl = jfa.FastAttnAttn(window_size=WINDOW, cfg_batched=cfg_batched)
    timpl = tfa.FastAttnAttn(window_size=WINDOW, cfg_batched=cfg_batched)
    jst = jax.tree_util.tree_map(lambda a: a[0], jimpl.init_state(1, b, s, h, d, jnp.float32))
    tstack = timpl.init_state(1, b, s, h, d, torch.float32)
    tst = {k: v[0] for k, v in tstack.items()}  # layer 0, views into the stack
    for m in CHAIN:
        q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
        for key in ("residual", "last_out"):
            tst[key].copy_(torch.from_numpy(np.array(jst[key])))
        jout, jst = jimpl(*(jnp.asarray(x, jdt) for x in (q, k, v)), dict(jst, method=jnp.int32(m)))
        tst["method"].fill_(int(m))
        tout, tst2 = timpl(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), tst)
        assert tst2 is tst and tout.dtype == tdt
        _close(tout.float().numpy(), jout, dtype)
        _close(tst["residual"].numpy(), jst["residual"], dtype)
        _close(tst["last_out"].numpy(), jst["last_out"], dtype)
        # the state is written in place, in the stacked tensors
        assert torch.equal(tstack["last_out"][0], tst["last_out"])
        if cfg_batched and m in (F.FULL_ATTN_CFG_SHARE, F.RESIDUAL_WINDOW_ATTN_CFG_SHARE,
                                 F.FULL_ATTN_CFG_SHARE_NO_RESIDUAL):
            assert torch.equal(tout[:1], tout[1:])  # mirrored cond half
    if dtype == "bf16":
        # OUTPUT_SHARE rounds the fp32 cache to bf16 and writes it back
        tst["last_out"].fill_(1.0 + 2.0**-12)
        tst["method"].fill_(int(F.OUTPUT_SHARE))
        out, _ = timpl(*(torch.zeros((b, s, h, d), dtype=tdt),) * 3, tst)
        assert bool((out == 1.0).all()) and bool((tst["last_out"] == 1.0).all())


@pytest.mark.parametrize("cfg_batched", [True, False])
def test_calibration_losses_match_jax(cfg_batched):
    b, s, h, d = 2, 32, 4, 16
    rng = np.random.default_rng(12)
    jcal = jfa.CalibrationAttn(window_size=WINDOW, cfg_batched=cfg_batched)
    tcal = tfa.CalibrationAttn(window_size=WINDOW, cfg_batched=cfg_batched)
    jst = jax.tree_util.tree_map(lambda a: a[0], jcal.init_state(1, b, s, h, d, jnp.float32))
    tst = {k: v[0] for k, v in tcal.init_state(1, b, s, h, d, torch.float32).items()}
    for _ in range(2):  # the second call measures the share loss against the first
        q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
        jout, jst = jcal(*map(jnp.asarray, (q, k, v)), jst)
        tout, tst = tcal(*map(torch.from_numpy, (q, k, v)), tst)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
        for key in ("window_loss", "share_loss", "full_cfg_loss", "window_cfg_loss"):
            want = float(jst[key])
            if np.isinf(want):
                assert not cfg_batched and np.isinf(float(tst[key])), key
            else:
                np.testing.assert_allclose(float(tst[key]), want, rtol=1e-5, err_msg=key)
    with pytest.raises(AssertionError):
        tcal(*map(torch.from_numpy, (q, k, v)), tst, joint_q=torch.from_numpy(q))


def _select_cases():
    cases = [  # the JAX package's own tables (tests/models/test_fast_attn.py)
        (np.array([0.5, 0.10, 0.10, 0.01]), np.array([0.9, 0.50, 0.05, 0.9]), None, None, 0.4),
        (np.array([0.5, 0.15, 0.5, 0.5]), np.array([0.9, 0.9, 0.9, 0.9]),
         np.array([0.5, 0.05, 0.5, 0.5]), np.array([0.5, 0.5, 0.25, 0.5]), 0.4),
    ]
    rng = np.random.default_rng(13)
    for i in range(20):
        wl, sl, wcl, fcl = (rng.random(28).astype(np.float32) * 0.6 for _ in range(4))
        cases.append((wl, sl, wcl if i % 2 else None, fcl if i % 3 else None, 0.5))
    return cases


def test_select_methods_and_optimize_plan_match_jax():
    for wl, sl, wcl, fcl, thr in _select_cases():
        want = jfa.select_methods(wl, sl, thr, len(wl), window_cfg_loss=wcl, full_cfg_loss=fcl)
        got = tfa.select_methods(wl, sl, thr, len(wl), window_cfg_loss=wcl, full_cfg_loss=fcl)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    plans = [np.array([[0, 0], [1, 2], [1, 3], [0, 2], [0, 0], [2, 2], [4, 2]], np.int32)]
    rng = np.random.default_rng(14)
    plans += [rng.integers(0, 5, (20, 28)).astype(np.int32) for _ in range(10)]
    for plan in plans:
        want = jfa.optimize_plan(plan)
        got = tfa.optimize_plan(plan)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tfa.optimize_plan(got), got)  # idempotent


def test_plan_json_files_cross_between_packages(tmp_path):
    plan = np.random.default_rng(15).integers(0, 7, (20, 28)).astype(np.int32)
    jfa.save_plan(plan, str(tmp_path / "jax.json"))
    np.testing.assert_array_equal(tfa.load_plan(str(tmp_path / "jax.json")), plan)
    tfa.save_plan(plan, str(tmp_path / "torch.json"))
    np.testing.assert_array_equal(jfa.load_plan(str(tmp_path / "torch.json")), plan)
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "torch.json").read_text()


# ---------------------------------------------------------------------------
# the whole slice, tiny
# ---------------------------------------------------------------------------

# after optimize_plan: layer 0 [FULL, WINDOW, FULL_NO_RESIDUAL, SHARE],
# layer 1 [FULL_CFG, WINDOW_CFG, FULL_CFG_NO_RESIDUAL, SHARE]
MIXED_PLAN = ((0, 3), (1, 4), (0, 3), (2, 2))


@pytest.fixture(scope="module")
def slice_setup():
    jm = dataclasses.replace(pixart_tiny(), dtype=jnp.float32)
    jv = dataclasses.replace(tiny_vae(), dtype=jnp.float32)
    jparams = spice_params(init_pixart(jax.random.PRNGKey(0), jm))
    jvae = init_vae_decoder(jax.random.PRNGKey(1), jv)
    tm = dataclasses.replace(tpix.pixart_tiny(), dtype=torch.float32)
    tv = dataclasses.replace(tvae.tiny_vae(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tvae_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jvae))
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 1, 6, jm.text_dim)).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, 0, 4:] = False  # padded uncond prompt
    latents0 = rng.standard_normal((1, 16, 16)).astype(np.float32)
    mesh = make_mesh(JParallel(), devices=jax.devices()[:1])
    common = dict(num_steps=STEPS, height=64, width=64, fast_attn_window=WINDOW)

    def run(plan):
        jc = JPipelineConfig(model=jm, vae=jv, fast_attn_plan=plan, **common)
        jlat = np.asarray(JPipeline(jparams, jvae, jc, mesh)._sample(
            jparams, jnp.asarray(text), jnp.asarray(mask), jnp.asarray(latents0)))
        tc = PixArtPipelineConfig(model=tm, vae=tv, fast_attn_plan=plan, **common)
        tlat = PixArtPipeline(tparams, tvae_params, tc, "cpu")(
            torch.from_numpy(text), torch.from_numpy(mask), latents=torch.from_numpy(latents0),
            decode=False)
        return jlat, tlat.numpy()

    return dict(run=run, jm=jm, jparams=jparams, tm=tm, tparams=tparams, tv=tv, jv=jv,
                text=text, mask=mask, common=common)


def test_all_full_plan_equals_lossless_and_jax(slice_setup):
    full = tuple((0,) * 2 for _ in range(STEPS))
    jlat, tlat = slice_setup["run"](full)
    _, tlossless = slice_setup["run"](None)
    assert (tfa.optimize_plan(full) == F.FULL_ATTN_NO_RESIDUAL).all()
    np.testing.assert_array_equal(tlat, tlossless)
    assert rel_err(tlat, jlat) < BOUND


def test_mixed_plan_with_all_seven_methods_matches_jax(slice_setup):
    assert sorted(set(tfa.optimize_plan(MIXED_PLAN).ravel().tolist())) == list(range(7))
    jlat, tlat = slice_setup["run"](MIXED_PLAN)
    _, tlossless = slice_setup["run"](None)
    # the plan moves the tiny model's latents by only ~1e-4, so the port must
    # also sit far closer to JAX than that move
    effect = rel_err(tlat, tlossless)
    assert effect > 0
    assert rel_err(tlat, jlat) < min(BOUND, 0.01 * effect)


def test_calibrate_pixart_picks_the_jax_plan(slice_setup, monkeypatch):
    """Both calibrations on JAX's ``prepare_latents(key)`` noise; the
    threshold is chosen so every loss is > 1e-3 (relative) away from every
    layer budget, so the plans cannot differ by an fp32 ordering."""
    st = slice_setup
    key = jax.random.PRNGKey(4)
    jcfg = JPipelineConfig(model=st["jm"], vae=st["jv"], **st["common"])
    tcfg = PixArtPipelineConfig(model=st["tm"], vae=st["tv"], **st["common"])
    lat = np.array(jprepare_latents(key, 1, jcfg.tokens, 16, jnp.float32))
    seen = []
    real_select = tfa.select_methods

    def recording(wl, sl, thr, n, window_cfg_loss=None, full_cfg_loss=None):
        seen.append(np.concatenate([wl, sl, window_cfg_loss, full_cfg_loss]))
        return real_select(wl, sl, thr, n, window_cfg_loss=window_cfg_loss,
                           full_cfg_loss=full_cfg_loss)

    monkeypatch.setattr(tfa, "select_methods", recording)
    text, mask = torch.from_numpy(st["text"]), torch.from_numpy(st["mask"])
    tfa.calibrate_pixart(st["tparams"], tcfg, text, mask, latents=torch.from_numpy(lat))
    losses = np.concatenate(seen)
    losses = losses[np.isfinite(losses)]
    depth = st["tm"].depth

    def margin(thr):
        budgets = np.arange(1, depth + 1) / depth * thr
        return np.min(np.abs(losses[:, None] - budgets[None]) / budgets[None])

    def n_methods(thr):
        return len({int(m) for row in seen for m in real_select(*np.split(row, 4)[:2], thr, depth,
                                                                 *np.split(row, 4)[2:])})

    thr = max((t for t in np.linspace(0.05, 2.0, 40) if n_methods(t) > 1), key=margin)
    assert margin(thr) > 1e-3, (thr, margin(thr))
    tplan = tfa.calibrate_pixart(st["tparams"], tcfg, text, mask, threshold=thr,
                                 latents=torch.from_numpy(lat))
    jplan = jfa.calibrate_pixart(st["jparams"], jcfg, jnp.asarray(st["text"]),
                                 jnp.asarray(st["mask"]), key, threshold=float(thr))
    np.testing.assert_array_equal(tplan, jplan)
    assert (tplan[0] == F.FULL_ATTN).all() and len(np.unique(tplan)) > 1
