"""Image output helpers (counterpart of ``compactfusion_tpu/utils/image.py``).

``to_uint8`` rounds [0, 1] images to uint8 as the JAX package does.  The
JAX package writes PNGs through PIL; the port writes and reads them with
``zlib`` and ``struct`` alone (8-bit RGB, no interlace, filter 0 on every
row), so the service and ``xDiTParallel.save`` need no imaging package.
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


def read_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG as :func:`png_bytes` writes them (8-bit RGB, no
    interlace, filter 0 on every row) -> (H, W, 3) uint8; checks every
    chunk's CRC and raises on any other form."""
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
    if depth != 8 or color != 2 or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type {color}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError("unsupported PNG: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
