"""Image output helpers (counterpart of ``compactfusion_tpu/utils/image.py``).

``to_uint8`` rounds [0, 1] images to uint8 as the JAX package does.  The
JAX package writes and reads PNGs through PIL; the port writes them with
``zlib`` and ``struct`` alone (8-bit RGB, no interlace, filter 0 on every
row) and reads 8-bit gray, RGB and RGBA ones with any row filter, so the
service, ``xDiTParallel.save`` and ConsisID's identity image need no
imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(images01) -> np.ndarray:
    """[0, 1] float images -> uint8, rounding to nearest
    (``(images * 255).round()``, the diffusers contract)."""
    arr = np.asarray(images01, np.float32)
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(img8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of a PNG file."""
    img8 = np.ascontiguousarray(img8, np.uint8)
    if img8.ndim != 3 or img8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img8.shape}")
    h, w, _ = img8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img8.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img8))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 none, 1 sub, 2 up, 3 average, 4
    Paeth) of (h, 1 + stride) filtered rows -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        kind, row = int(raw[y, 0]), raw[y, 1:].astype(np.int64)
        if kind == 0:
            cur = row
        elif kind == 1:  # sub: a running sum along each channel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            cur = (row + prior) % 256
        elif kind in (3, 4):
            cur = row.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prior[x])
                c = int(prior[x - bpp]) if x >= bpp else 0
                pred = (a + b) // 2 if kind == 3 else _paeth(a, b, c)
                cur[x] = (cur[x] + pred) % 256
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit gray, RGB or RGBA PNG without interlace (any
    row filter) -> (H, W, 3) uint8: gray repeated, alpha dropped (PIL's
    ``convert("RGB")``); checks every chunk's CRC and raises on any other
    form."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type {color}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if not raw[:, 0].any():
        pix = raw[:, 1:].reshape(h, w, channels).copy()
    else:
        pix = _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
    if channels == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def load_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 (:func:`read_png`)."""
    with open(path, "rb") as f:
        return read_png(f.read())


#: fixed-point bits of the 8-bit resampler (Pillow's ``PRECISION_BITS``)
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = -0.5, support 2)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's separable 8-bit resampler along ``axis``: the
    antialiased bicubic window of each output pixel, coefficients
    normalized, rounded to fixed point, the sum rounded and clipped to
    uint8 (``precompute_coeffs`` / ``normalize_coeffs_8bpc``)."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    moved = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.empty((out_size,) + moved.shape[1:], np.uint8)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) / fscale)
        if w.sum() != 0.0:
            w = w / w.sum()
        k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
        acc = (1 << (_PRECISION_BITS - 1)) + np.tensordot(k, moved[lo:hi], axes=(0, 0))
        out[i] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8 by the resampler of
    PIL's ``Image.resize`` (default bicubic, horizontal pass first);
    ``tests/test_torch_face.py`` holds it against PIL."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img
