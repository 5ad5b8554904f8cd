"""The HunyuanVideo causal 3D VAE decoder (the ``hv_*`` half of
``models/vae3d.py``) vs the JAX package, fp32, bound 2e-4 (the fp32 bound
of tests/io/test_backbone_parity.py).

* ``init_hv_vae3d_decoder``'s tree; ``hv_vae3d_decode`` on ``tiny_hv_vae3d``
  with JAX's weights (3 latent frames: time upsampling, the first frame
  kept once), dense and tiled.
* The recorded divergence, the mid attention: JAX hands a (T*h*w)^2 causal
  frame mask to the dense math path; the port runs one unmasked call per
  query frame over its key prefix.  Held against JAX's ``_mid_attn_hv`` at
  C = 64 and 5 frames (and against the masked math path of the port's own
  attention), 1e-5.
* The chunked forms (convs over chunks of output frames with their causal
  window, the upsampler's frames made chunk by chunk, the GroupNorm's
  statistics summed over frame chunks) against the unchunked ones, 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import vae3d as jvae3d
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import vae3d as tvae3d
from compactfusion_tpu_torch.ops.attention import attn_with_lse
from tests.helpers import rel_err
from tests.test_torch_api import _np

BOUND = 2e-4


@pytest.fixture(scope="module")
def tiny():
    jv = dataclasses.replace(jvae3d.tiny_hv_vae3d(), dtype=jnp.float32)
    params = jvae3d.init_hv_vae3d_decoder(jax.random.PRNGKey(3), jv)
    # GroupNorm affines away from (1, 0), so the norms' params matter
    rng = np.random.default_rng(0)

    def spice(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']") or name.endswith("['b']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape) if name.endswith("['g']")
                               else rng.normal(0, 0.2, a.shape), a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(spice, params)
    tv = dataclasses.replace(tvae3d.tiny_hv_vae3d(), dtype=torch.float32)
    return jv, params, tv, params_from_numpy(_np(params))


def test_init_tree_and_decode_match_jax(tiny):
    jv, jp, tv, tp = tiny
    own = tvae3d.init_hv_vae3d_decoder(torch.Generator().manual_seed(0), tv)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    assert tvae3d.hunyuanvideo_vae() == dataclasses.replace(
        tvae3d.VAE3DConfig(), block_out_channels=(128, 256, 512, 512), layers_per_block=2, scaling_factor=0.476986)
    z = np.random.default_rng(1).standard_normal((1, 3, 6, 5, 4)).astype(np.float32)
    want = np.asarray(jvae3d.hv_vae3d_decode(jp, jnp.asarray(z), jv))
    got = tvae3d.hv_vae3d_decode(tp, torch.from_numpy(z), tv)
    assert got.shape == want.shape == (1, 5, 12, 10, 3)
    assert rel_err(got.numpy(), want) < BOUND
    # tiled: 4-latent tiles with overlap over a 6 x 8 latent
    jt = dataclasses.replace(jv, use_tiling=True, tile_latent_size=4, tile_overlap_factor=0.25)
    tt = dataclasses.replace(tv, use_tiling=True, tile_latent_size=4, tile_overlap_factor=0.25)
    z = np.random.default_rng(2).standard_normal((1, 2, 6, 8, 4)).astype(np.float32)
    want = np.asarray(jvae3d.hv_vae3d_decode(jp, jnp.asarray(z), jt))
    got = tvae3d.hv_vae3d_decode(tp, torch.from_numpy(z), tt)
    assert got.shape == want.shape and rel_err(got.numpy(), want) < BOUND


def test_mid_attention_per_frame_prefix_matches_the_masked_path():
    """The recorded divergence: per query frame over its key prefix, where
    JAX builds the whole causal frame mask."""
    c, t, h, w = 64, 5, 3, 4
    rng = np.random.default_rng(5)
    p = {"norm": {"g": rng.uniform(0.5, 1.5, c).astype(np.float32), "b": rng.normal(0, 0.1, c).astype(np.float32)}}
    for k in ("q", "k", "v", "out"):
        p[k] = {"w": (rng.standard_normal((c, c)) * 0.2).astype(np.float32),
                "b": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    x = rng.standard_normal((2, t, h, w, c)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = np.asarray(jvae3d._mid_attn_hv(jp, jnp.asarray(x), 8))
    tp = params_from_numpy(p)
    got = tvae3d._mid_attn_hv(tp, torch.from_numpy(x), 8)
    assert rel_err(got.numpy(), want) < 1e-5
    # the same function as the port's own masked math path
    y = tvae3d._plain_groupnorm3(tp["norm"], torch.from_numpy(x), 8).reshape(2, t * h * w, c)
    q, k, v = (tvae3d.cm.linear(tp[n], y)[:, :, None] for n in ("q", "k", "v"))
    frame = torch.arange(t).repeat_interleave(h * w)
    o, _ = attn_with_lse(q, k, v, mask=frame[:, None] >= frame[None, :])
    masked = torch.from_numpy(x) + tvae3d.cm.linear(tp["out"], o[:, :, 0]).reshape(x.shape)
    assert rel_err(got.numpy(), masked.numpy()) < 1e-5


def test_chunked_forms_match_unchunked(tiny, monkeypatch):
    jv, jp, tv, tp = tiny
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 6, 5, 4)).astype(np.float32))
    whole = tvae3d.hv_vae3d_decode(tp, z, tv)
    x = torch.randn((1, 7, 6, 5, 16), generator=torch.Generator().manual_seed(1))
    conv = tp["up"][0]["upsample_conv"]
    pieces = {"conv": tvae3d._causal_conv3_repl(conv, x), "norm": tvae3d._plain_groupnorm3(tp["norm_out"],
                                                                                             x[..., :8], 4),
              "up": tvae3d._upsample3_hv(conv, x, True)}
    monkeypatch.setattr(tvae3d, "CONV_CHUNK_ELEMS", 6 * 5 * 16 * 2)
    monkeypatch.setattr(tvae3d, "NORM_CHUNK_ELEMS", 6 * 5 * 8)
    assert rel_err(tvae3d.hv_vae3d_decode(tp, z, tv).numpy(), whole.numpy()) < 1e-6
    assert rel_err(tvae3d._causal_conv3_repl(conv, x).numpy(), pieces["conv"].numpy()) < 1e-6
    assert rel_err(tvae3d._plain_groupnorm3(tp["norm_out"], x[..., :8], 4).numpy(), pieces["norm"].numpy()) < 1e-6
    up = tvae3d._upsample3_hv(conv, x, True)
    assert up.shape == (1, 13, 12, 10, 16) and rel_err(up.numpy(), pieces["up"].numpy()) < 1e-6
