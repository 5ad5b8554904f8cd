"""The port's quality-eval package (``compactfusion_tpu_torch/eval``)
against the JAX package's on the same numpy inputs: PSNR, SSIM and their
video forms at 1e-5, the Frechet maths and the stats round trip at 1e-6,
LPIPS at 2e-4; each extractor on the same torchvision- or pytorch-i3d-named
state dict with randomised BatchNorm statistics at 2e-4 (Inception at
B2 x 96^2, VGG at B2 x 32^2, I3D at B1 x 16 x 224^2, the JAX tests' sizes),
each converter bit-equal to JAX's in fp32, and ``io/from_jax.py`` on each
``init_*`` tree."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.eval import i3d as ji3d
from compactfusion_tpu.eval import inception as jinc
from compactfusion_tpu.eval import metrics as jm
from compactfusion_tpu.eval import vgg as jvgg
from compactfusion_tpu_torch.eval import i3d as ti3d
from compactfusion_tpu_torch.eval import inception as tinc
from compactfusion_tpu_torch.eval import metrics as tm
from compactfusion_tpu_torch.eval import vgg as tvgg
from compactfusion_tpu_torch.io import from_jax
from tests import torch_ref
from tests.helpers import rel_err

METRIC_REL = 1e-5
FEATURE_REL = 2e-4


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _pair(shape):
    a = _uniform(0, shape)
    return a, np.clip(a + 0.1 * _uniform(1, shape) - 0.05, 0, 1).astype(np.float32)


@pytest.mark.parametrize("name,shape", [
    ("mse", (2, 32, 32, 3)), ("psnr", (2, 32, 32, 3)), ("psnr", (32, 32, 3)), ("ssim", (2, 32, 40, 3)),
    ("video_psnr", (2, 3, 24, 24, 3)), ("video_ssim", (1, 3, 24, 24, 3)),
])
def test_metric_matches_jax(name, shape):
    a, b = _pair(shape)
    got = float(getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= METRIC_REL * abs(want), (got, want)
    if name != "mse":  # equal inputs: PSNR at its 1e-12 floor, SSIM 1
        same = float(getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(a)))
        assert same == pytest.approx(120.0 if "psnr" in name else 1.0, rel=1e-6)


def test_psnr_is_the_mean_of_per_image_psnrs():
    a, b = _pair((3, 16, 16, 3))
    b[1] = a[1]  # one perfect image: a pooled MSE would hide the others
    per = [float(tm.psnr(torch.from_numpy(a[i]), torch.from_numpy(b[i]))) for i in range(3)]
    assert float(tm.psnr(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(np.mean(per), rel=1e-6)


def test_frechet_maths_and_stats_roundtrip_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    fa = rng.standard_normal((256, 16))
    fb = fa * 0.9 + 0.5 + 0.1 * rng.standard_normal((256, 16))
    for fn in ("fid_from_features", "fvd_from_features"):
        got, want = getattr(tm, fn)(fa, fb), getattr(jm, fn)(fa, fb)
        assert got == pytest.approx(want, rel=1e-6)
    assert tm.fid_from_features(fa, fa) == pytest.approx(0.0, abs=1e-6)
    for got, want in zip(tm.feature_stats(fb), jm.feature_stats(fb)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    mu, cov = tm.feature_stats(fb)
    np.savez(tmp_path / "stats.npz", mu=mu, sigma=cov)
    loaded = tm.load_fid_stats_npz(str(tmp_path / "stats.npz"))
    d = tm.frechet_distance(*tm.feature_stats(fa), *loaded)
    assert d == pytest.approx(jm.frechet_distance(*jm.feature_stats(fa), *jm.load_fid_stats_npz(
        str(tmp_path / "stats.npz"))), rel=1e-6)
    assert d == pytest.approx(tm.fvd_from_features(fa, fb), rel=1e-6)


def test_lpips_class_matches_jax():
    a, b = _pair((2, 16, 16, 3))
    weights = [1.0, 0.5]
    got = tm.LPIPS(lambda x: [x, x[:, ::2, ::2]], weights)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jm.LPIPS(lambda x: [x, x[:, ::2, ::2]], weights)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2,) and rel_err(got, want) < FEATURE_REL
    same = tm.LPIPS(lambda x: [x])(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert (same < 1e-10).all()


def _vgg_state():
    """A torchvision-named ``vgg16().features`` state dict (seeded convs)."""
    torch.manual_seed(0)
    return {f"features.{idx}.{k}": v.detach().numpy()
            for idx, ci, co in jvgg.VGG16_CONVS
            for k, v in torch.nn.Conv2d(ci, co, 3, padding=1).state_dict().items()}


def _randomize_bn(module, rng):
    for m in module.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
            m.running_mean.copy_(torch.tensor(rng.standard_normal(m.num_features) * 0.2, dtype=torch.float32))
            m.running_var.copy_(torch.tensor(0.5 + rng.random(m.num_features), dtype=torch.float32))


def _state(ref, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        _randomize_bn(ref.eval(), rng)
    return {k: v.detach().numpy() for k, v in ref.state_dict().items()}


def _same_weights(tree, jtree):
    """The port's (O, I, *k) weights are the JAX (*k, I, O) ones, bit for bit."""
    for name, p in jtree.items():
        w = tree[name]["w"].numpy()
        order = tuple(range(2, w.ndim)) + (1, 0)
        np.testing.assert_array_equal(np.transpose(w, order), np.asarray(p["w"]), err_msg=name)
        np.testing.assert_array_equal(tree[name]["b"].numpy(), np.asarray(p["b"]), err_msg=name)


def test_vgg_lpips_matches_jax():
    state = _vgg_state()
    params, jparams = tvgg.convert_vgg16(state, device="cpu"), jvgg.convert_vgg16(state)
    _same_weights(params, jparams)
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    lins = [np.abs(rng.standard_normal(c)).astype(np.float32) for c in (64, 128, 256, 512, 512)]
    for port_lins, jax_lins in ((None, None), ([torch.from_numpy(w) for w in lins], [jnp.asarray(w) for w in lins])):
        got = tvgg.make_lpips(params, port_lins)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(jvgg.make_lpips(jparams, jax_lins)(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == (2,) and rel_err(got, want) < FEATURE_REL, (got, want)
    feats = tvgg.vgg16_features(params, torch.from_numpy(a))
    jfeats = jvgg.vgg16_features(jparams, jnp.asarray(a))
    assert [tuple(f.shape) for f in feats] == [f.shape for f in jfeats]
    lin_state = {f"lin{i}.model.1.weight": w.reshape(-1, 1, 1, 1) for i, w in enumerate(lins)}
    for got, want in zip(tvgg.load_lpips_lins(lin_state, device="cpu"), jvgg.load_lpips_lins(lin_state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_converters_default_to_the_card():
    """Weights loaded from a file land on the card unless the caller asks
    for the CPU, as the family builders do; the tests here pass the CPU."""
    for convert in (tvgg.convert_vgg16, tvgg.load_lpips_lins, tinc.convert_inception_v3, ti3d.convert_i3d):
        assert inspect.signature(convert).parameters["device"].default == "cuda", convert.__name__


def test_inception_matches_jax():
    torch.manual_seed(41)
    state = _state(torch_ref.InceptionV3Ref(), 42)
    params, jparams = tinc.convert_inception_v3(state, device="cpu"), jinc.convert_inception_v3(state)
    _same_weights(params, jparams)
    img = np.random.default_rng(42).standard_normal((2, 96, 96, 3)).astype(np.float32) * 0.5
    got = tinc.inception_pool_features(params, torch.from_numpy(img)).numpy()
    want = np.asarray(jinc.inception_pool_features(jparams, jnp.asarray(img)))
    assert got.shape == (2, tinc.FEATURE_DIM) and rel_err(got, want) < FEATURE_REL, rel_err(got, want)


def test_i3d_matches_jax():
    torch.manual_seed(43)
    state = _state(torch_ref.I3DRef(), 44)
    params, jparams = ti3d.convert_i3d(state, device="cpu"), ji3d.convert_i3d(state)
    _same_weights(params, jparams)
    vid = np.random.default_rng(44).standard_normal((1, 16, 224, 224, 3)).astype(np.float32) * 0.5
    got = ti3d.i3d_features(params, torch.from_numpy(vid)).numpy()
    want = np.asarray(ji3d.i3d_features(jparams, jnp.asarray(vid)))
    assert got.shape == (1, ti3d.FEATURE_DIM) and rel_err(got, want) < FEATURE_REL, rel_err(got, want)


def test_i3d_same_padding_matches_xla():
    """The explicit TF "SAME" pads (asymmetric at stride 2; -inf under a
    max-pool) against XLA's on odd and even sizes."""
    x = np.random.default_rng(5).standard_normal((1, 2, 9, 14, 15)).astype(np.float32)
    xt = torch.from_numpy(x)
    for k, s in (((3, 3, 3), (2, 2, 2)), ((1, 3, 3), (1, 2, 2)), ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))):
        got = ti3d._maxpool(xt, k, s).numpy()
        want = np.asarray(ji3d._maxpool(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), k, s)).transpose(0, 4, 1, 2, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["vgg", "inception", "i3d"])
def test_from_jax_carries_each_init_tree(family):
    """``io/from_jax.py`` on a tree of the JAX ``init_*`` structure (its
    shapes by ``jax.eval_shape``, numpy leaves from a seed): every weight
    moved to PyTorch's layout bit for bit, the shapes the port's own
    ``init_*`` draws; the carried VGG computes JAX's features."""
    jinit, tinit = {"vgg": (jvgg.init_vgg16, tvgg.init_vgg16),
                    "inception": (jinc.init_inception_v3, tinc.init_inception_v3),
                    "i3d": (ji3d.init_i3d, ti3d.init_i3d)}[family]
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    params = from_jax.conv_tree_from_jax(jparams)
    _same_weights(params, jparams)
    seeded = tinit(torch.Generator().manual_seed(0))
    assert {k: {n: tuple(t.shape) for n, t in p.items()} for k, p in seeded.items()} == \
        {k: {n: tuple(t.shape) for n, t in p.items()} for k, p in params.items()}
    if family == "vgg":
        img = np.random.default_rng(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
        got = tvgg.vgg16_features(params, torch.from_numpy(img))
        want = jvgg.vgg16_features(jparams, jnp.asarray(img))
        for g, w in zip(got, want):
            assert rel_err(g.numpy(), np.asarray(w)) < FEATURE_REL


def test_fp32_convs_restores_the_cudnn_flag():
    before = torch.backends.cudnn.allow_tf32
    with tm.fp32_convs():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before
