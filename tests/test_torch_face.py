"""ConsisID's face encoder and the identity-image path vs the JAX package.

* ``lfe_forward`` on ``lfe_tiny`` with JAX's weights, fp32, within 2e-4
  (the fp32 bound of tests/io/test_backbone_parity.py); ``init_lfe``'s tree.
* The stand-in features: ``image_face_features`` and ``image_to_id_states``
  bit for bit against JAX's from the same decoded image arrays (the seeded
  numpy projections are the same draws), and from the same PNG file.
* The recorded divergence, the image reader: the port decodes PNGs itself
  and resizes with ``utils/image.resize_uint8`` where JAX calls PIL's
  ``Image.open(...).convert("RGB").resize``; both held against PIL here
  (Pillow on the CPU): the decode for gray, RGB and RGBA files and every row
  filter, the resize bit for bit at the sizes the stand-in uses and others.
"""

import dataclasses
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from compactfusion_tpu.models import face as jface
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import face as tface
from compactfusion_tpu_torch.utils import image as timage
from tests.helpers import rel_err
from tests.test_torch_api import _np

BOUND = 2e-4


def _photo(h=150, w=110, seed=0):
    """A smooth image with noise (a face-photo stand-in), uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 90 * np.cos(yy / 7.0), (xx + yy) % 256], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(224, 224), (32, 32), (500, 333), (7, 9)])
def test_resize_matches_pil(size):
    for img in (_photo(), _photo(301, 257, 1), _photo(24, 40, 2)):
        want = np.asarray(Image.fromarray(img).resize(size[::-1]))
        np.testing.assert_array_equal(timage.resize_uint8(img, *size), want)


def _png_with_filters(img, filters):
    """A PNG of ``img`` whose row y takes filter ``filters[y % len]``."""
    h, w, c = img.shape
    bpp, raw = c, []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int64)
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prior
        elif kind == 3:
            f = row - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prior = row

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_matches_pil(channels):
    img = _photo(13, 11, channels)
    img = img[..., :1] if channels == 1 else (np.concatenate([img, img[..., :1]], -1) if channels == 4 else img)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        data = _png_with_filters(img, filters)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(timage.read_png(data), want)
    for mode in ("L", "RGB", "RGBA"):  # files PIL writes
        buf = io.BytesIO()
        Image.fromarray(_photo(20, 17, 3)).convert(mode).save(buf, format="PNG", optimize=True)
        np.testing.assert_array_equal(timage.read_png(buf.getvalue()),
                                      np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))


def test_lfe_forward_matches_jax():
    jc = jface.lfe_tiny()
    jp = jface.init_lfe(jax.random.PRNGKey(3), jc)
    tc = tface.lfe_tiny()
    own = tface.init_lfe(torch.Generator().manual_seed(0), tc)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(_np(jp))
    rng = np.random.default_rng(4)
    id_cond = rng.standard_normal((2, jc.id_dim)).astype(np.float32)
    vits = [rng.standard_normal((2, 9, jc.vit_dim)).astype(np.float32) for _ in range(jc.num_scale)]
    want = np.asarray(jface.lfe_forward(jp, jnp.asarray(id_cond), [jnp.asarray(v) for v in vits], jc))
    got = tface.lfe_forward(params_from_numpy(_np(jp)), torch.from_numpy(id_cond),
                            [torch.from_numpy(v) for v in vits], tc)
    assert got.shape == (2, jc.num_queries, jc.output_dim)
    assert rel_err(got.numpy(), want) < BOUND
    assert tface.lfe_consisid() == dataclasses.replace(tface.LFEConfig())


def test_identity_tokens_bit_equal(tmp_path, monkeypatch):
    path = str(tmp_path / "face.png")
    Image.fromarray(_photo()).save(path)
    # the same decoded image arrays on both sides
    monkeypatch.setattr(jface, "_load_image", lambda p, size=224: tface._load_image(p, size))
    for cfg_j, cfg_t in ((jface.lfe_tiny(), tface.lfe_tiny()), (jface.lfe_consisid(), tface.lfe_consisid())):
        j_cond, j_hidden = jface.image_face_features(path, cfg_j)
        t_cond, t_hidden = tface.image_face_features(path, cfg_t)
        np.testing.assert_array_equal(t_cond.numpy(), np.asarray(j_cond))
        assert len(t_hidden) == cfg_t.num_scale and t_hidden[0].shape == (1, 576, cfg_t.vit_dim)
        for t, j in zip(t_hidden, j_hidden):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for tokens, dim in ((5, 16), (5, 2048)):
        np.testing.assert_array_equal(tface.image_to_id_states(path, tokens, dim).numpy(),
                                      np.asarray(jface.image_to_id_states(path, tokens, dim)))
    # and from the file itself: the port's reader and resizer give PIL's arrays
    monkeypatch.undo()
    np.testing.assert_array_equal(tface.image_to_id_states(path, 5, 16).numpy(),
                                  np.asarray(jface.image_to_id_states(path, 5, 16)))
    np.testing.assert_array_equal(tface._load_image(path), jface._load_image(path))
