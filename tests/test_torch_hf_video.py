"""The port's converters of the video families of this slice
(``io/hf.py::convert_latte``, ``convert_hunyuanvideo``, ``convert_consisid``,
``convert_local_facial_extractor``, ``convert_hv_vae3d_decoder``):

* equal to the JAX package's converters bit for bit, in fp32 and bf16, on
  the state dicts of ``tests/torch_ref.py``'s ``LatteRef``,
  ``HunyuanVideoRef``, ``ConsisIDRef`` (and a ConsisID checkpoint without
  perceiver tensors: zero projections), ``LocalFacialExtractorRef`` (alone
  and under the transformer's ``local_facial_extractor.`` prefix) and
  ``HunyuanVideoVAEDecoderRef``; every key read;
* the port's forwards on the converted weights against those references at
  2e-4 (the fp32 bound of tests/io/test_backbone_parity.py);
* every key of the official inventories (``tests/io/fixtures/latte-1.keys.
  txt``: 28 pairs, 967 tensors; ``hunyuanvideo.keys.txt``: 20 + 40 blocks,
  1264 tensors) read, the converted trees those of ``init_latte`` /
  ``init_hunyuanvideo``; the names are the inventories', widths divided
  (Latte's 1152-multiples by 18 and its text 4096 to 64; HunyuanVideo's by
  16: dim 192, 24 heads of 8).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.models import consisid as jcon
from compactfusion_tpu.models import face as jface
from compactfusion_tpu.models import hunyuanvideo as jhv
from compactfusion_tpu.models import latte as jlatte
from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import consisid as tcon
from compactfusion_tpu_torch.models import face as tface
from compactfusion_tpu_torch.models import hunyuanvideo as thv
from compactfusion_tpu_torch.models import latte as tlatte
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.models.cogvideox import video_positions
from tests import torch_ref
from tests.helpers import rel_err
from tests.io.test_real_keymaps import TrackingState
from tests.test_torch_cogvideox import _assert_trees_equal

BOUND = 2e-4
FIXTURES = Path(__file__).resolve().parent / "io" / "fixtures"
LFE = dict(id_dim=24, vit_dim=16, depth=10, dim_head=4, heads=4, num_id_token=3, num_queries=6, output_dim=20,
           ff_mult=2, num_scale=5)


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _tracked(state):
    t = TrackingState({k: v.shape for k, v in state.items()})
    t.update(state)
    return t


def _refs():
    torch.manual_seed(31)
    return {
        "latte": torch_ref.LatteRef(dim=64, num_pairs=2, heads=4, patch=2, in_channels=4, out_channels=8,
                                    text_dim=32, sample_size=8, max_frames=8).eval(),
        "hunyuanvideo": torch_ref.HunyuanVideoRef(dim=64, double_layers=2, single_layers=2, heads=4,
                                                  in_channels=16, text_dim=32, pooled_dim=16, axes_dim=(8, 4, 4),
                                                  refiner_layers=2).eval(),
        "consisid": torch_ref.ConsisIDRef(id_dim=16, interval=2, dim=64, depth=2, heads=4, patch=2, in_channels=16,
                                          text_dim=32, time_embed_dim=32, axes_dim=(8, 4, 4)).eval(),
        "lfe": torch_ref.LocalFacialExtractorRef(**LFE).eval(),
        "hv_vae": torch_ref.HunyuanVideoVAEDecoderRef(latent_channels=4, out_channels=3, block_out_channels=(8, 16),
                                                      layers_per_block=1, groups=4,
                                                      temporal_compress_levels=1).eval(),
    }


@pytest.fixture(scope="module")
def refs():
    return _refs()


def _configs(dtype):
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    return {
        "latte": (dataclasses.replace(jlatte.latte_tiny(), dtype=jt), dataclasses.replace(tlatte.latte_tiny(), dtype=tt)),
        "hunyuanvideo": (dataclasses.replace(jhv.hunyuanvideo_tiny(), dtype=jt),
                         dataclasses.replace(thv.hunyuanvideo_tiny(), dtype=tt)),
        "consisid": (dataclasses.replace(jcon.consisid_tiny(), dtype=jt),
                     dataclasses.replace(tcon.consisid_tiny(), dtype=tt)),
        "lfe": (dataclasses.replace(jface.lfe_tiny(), dtype=jt), dataclasses.replace(tface.lfe_tiny(), dtype=tt)),
        "hv_vae": (dataclasses.replace(jvae3d.tiny_hv_vae3d(), dtype=jt),
                   dataclasses.replace(tvae3d.tiny_hv_vae3d(), dtype=tt)),
    }


CONVERT = {"latte": "convert_latte", "hunyuanvideo": "convert_hunyuanvideo", "consisid": "convert_consisid",
           "lfe": "convert_local_facial_extractor", "hv_vae": "convert_hv_vae3d_decoder"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(CONVERT))
def test_converters_match_jax_bit_for_bit(refs, family, dtype):
    ref = refs[family]
    state = ref.state_dict_flat() if family == "consisid" else _state(ref)
    jc, tc = _configs(dtype)[family]
    kw = {"prefix": ""} if family == "lfe" else {}
    tracked = _tracked(state)
    _assert_trees_equal(getattr(thf, CONVERT[family])(tracked, tc, **kw),
                        getattr(jhf, CONVERT[family])(state, jc, **kw), dtype)
    assert set(tracked) == tracked.read
    if family == "lfe":  # inside the transformer's state dict
        nested = {f"local_facial_extractor.{k}": v for k, v in state.items()}
        _assert_trees_equal(thf.convert_local_facial_extractor(nested, tc),
                            jhf.convert_local_facial_extractor(nested, jc), dtype)
    if family == "consisid":  # no perceiver tensors: zero projections, unit norms
        bare = {k: v for k, v in state.items() if not k.startswith("perceiver_cross_attention.")}
        _assert_trees_equal(thf.convert_consisid(bare, tc), jhf.convert_consisid(bare, jc), dtype)


def test_forwards_on_converted_weights_match_the_references(refs):
    f32 = _configs("float32")
    rng = np.random.default_rng(15)
    # Latte: 3 frames of 4 x 4 patches
    tc = f32["latte"][1]
    p = thf.convert_latte(_state(refs["latte"]), tc)
    b, f, hp, wp = 2, 3, 4, 4
    lat = rng.standard_normal((b, f, 4, 8, 8)).astype(np.float32)
    t = np.array([123.0, 704.0], np.float32)
    text = rng.standard_normal((b, 6, 32)).astype(np.float32)
    with torch.no_grad():
        want = refs["latte"](torch.tensor(lat), torch.tensor(t), torch.tensor(text), f).numpy()
    tokens = torch.cat([tcm.patchify(torch.from_numpy(lat[:, i]).permute(0, 2, 3, 1), 2) for i in range(f)], dim=1)
    got, _ = tlatte.latte_forward(p, tokens, torch.from_numpy(t), torch.from_numpy(text), tc, frames_local=f,
                                  frames_total=f, spatial_tokens=hp * wp,
                                  pos_embed=tcm.sincos_pos_embed_2d(tc.dim, hp, wp),
                                  temporal_pos_embed=tcm._sincos_embed_1d(torch.arange(f, dtype=torch.float32),
                                                                          tc.dim))
    assert got.shape == want.shape and rel_err(got.numpy(), want) < BOUND
    # HunyuanVideo
    tc = f32["hunyuanvideo"][1]
    p = thf.convert_hunyuanvideo(_state(refs["hunyuanvideo"]), tc)
    f, hp, wp = 2, 4, 4
    vid = rng.standard_normal((2, f * hp * wp, 16)).astype(np.float32)
    txt = rng.standard_normal((2, 6, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    t = np.array([212.0, 780.0], np.float32)
    g = np.array([6000.0, 6000.0], np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    pos = thv.hunyuanvideo_positions(f, hp, wp)
    txt_pos = torch.zeros((6, 3), dtype=torch.int64)
    with torch.no_grad():
        want = refs["hunyuanvideo"](torch.tensor(vid), torch.tensor(txt), torch.tensor(pooled), torch.tensor(t),
                                    torch.tensor(g), pos, txt_pos, torch.tensor(mask)).numpy()
    got, _, _ = thv.hunyuanvideo_forward(p, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(pooled),
                                         torch.from_numpy(t), torch.from_numpy(g), tc,
                                         video_rope=tcm.rope_frequencies(pos, tc.axes_dim, theta=256.0),
                                         txt_rope=tcm.rope_frequencies(txt_pos, tc.axes_dim, theta=256.0),
                                         text_mask=torch.from_numpy(mask))
    assert rel_err(got.numpy(), want) < BOUND
    # ConsisID
    tc = f32["consisid"][1]
    p = thf.convert_consisid(refs["consisid"].state_dict_flat(), tc)
    vid = rng.standard_normal((2, f * hp * wp, 64)).astype(np.float32)
    ids = rng.standard_normal((2, 5, 16)).astype(np.float32)
    t = np.array([230.0, 540.0], np.float32)
    pos = video_positions(f, hp, wp)
    with torch.no_grad():
        want = refs["consisid"](torch.tensor(vid), torch.tensor(txt), torch.tensor(t), pos, torch.tensor(ids)).numpy()
    got, _ = tcon.consisid_forward(p, torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(ids),
                                   torch.from_numpy(t), tc, video_rope=tcm.rope_frequencies(pos, tc.axes_dim))
    assert rel_err(got.numpy(), want) < BOUND
    # the face encoder
    tc = f32["lfe"][1]
    p = thf.convert_local_facial_extractor(_state(refs["lfe"]), tc, prefix="")
    id_cond = rng.standard_normal((2, tc.id_dim)).astype(np.float32)
    vits = [rng.standard_normal((2, 7, tc.vit_dim)).astype(np.float32) for _ in range(tc.num_scale)]
    with torch.no_grad():
        want = refs["lfe"](torch.tensor(id_cond), [torch.tensor(v) for v in vits]).numpy()
    got = tface.lfe_forward(p, torch.from_numpy(id_cond), [torch.from_numpy(v) for v in vits], tc)
    assert rel_err(got.numpy(), want) < BOUND
    # the HunyuanVideo VAE decoder (scaling 1, as the reference takes raw latents)
    tc = dataclasses.replace(f32["hv_vae"][1], scaling_factor=1.0)
    p = thf.convert_hv_vae3d_decoder(_state(refs["hv_vae"]), tc)
    z = rng.standard_normal((1, 4, 3, 6, 6)).astype(np.float32)
    with torch.no_grad():
        want = refs["hv_vae"](torch.tensor(z)).numpy()
    got = tvae3d.hv_vae3d_decode(p, torch.from_numpy(z).permute(0, 2, 3, 4, 1), tc).permute(0, 4, 1, 2, 3)
    assert got.shape == want.shape and rel_err(got.numpy(), want) < BOUND


def _inventory(name, scale):
    lines = [ln.split() for ln in (FIXTURES / name).read_text().splitlines() if ln and not ln.startswith("#")]
    return {k: tuple(scale(int(d)) for d in dims.split(",")) for k, dims in lines}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def test_convert_latte_reads_every_key_of_the_latte1_inventory():
    shapes = _inventory("latte-1.keys.txt", lambda n: n // 18 if n % 1152 == 0 else (64 if n == 4096 else n))
    assert len(shapes) == 967
    cfg = dataclasses.replace(tlatte.latte_1(), dim=64, text_dim=64, heads=4, dtype=torch.float32)
    assert cfg.num_pairs == 28
    state = TrackingState(shapes)
    params = thf.convert_latte(state, cfg)
    assert set(state) == state.read
    assert _shapes(params) == _shapes(tlatte.init_latte(torch.Generator().manual_seed(0), cfg))


def test_convert_hunyuanvideo_reads_every_key_of_the_inventory():
    wide = (128, 768, 3072, 4096, 6144, 9216, 12288, 15360, 18432)
    shapes = _inventory("hunyuanvideo.keys.txt", lambda n: n // 16 if n in wide else n)
    assert len(shapes) == 1264
    cfg = dataclasses.replace(thv.hunyuanvideo_config(), dim=192, text_dim=256, pooled_dim=48, axes_dim=(2, 2, 4),
                              dtype=torch.float32)
    assert (cfg.double_layers, cfg.single_layers, cfg.heads, cfg.head_dim) == (20, 40, 24, 8)
    state = TrackingState(shapes)
    params = thf.convert_hunyuanvideo(state, cfg)
    assert set(state) == state.read
    assert _shapes(params) == _shapes(thv.init_hunyuanvideo(torch.Generator().manual_seed(0), cfg))
