"""Minimal PNG writer (RGB/RGBA 8-bit) for screenshots and golden images.

Fills the role of the vendored stb_image_write PNG path in the reference
(Common/stb_image_write.{h,cpp}; used by RayTracedGGX::SaveImage,
RayTracedGGX.cpp:719-739).  Pure Python + zlib, no external deps.
Copied from raytracedggx_tpu/io/png.py.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 (or float in [0,1]) image as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255
                      ).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    assert c in (3, 4), f"unsupported channel count {c}"
    color_type = 2 if c == 3 else 6

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def tonemapped_u8(rgb_linear: np.ndarray) -> np.ndarray:
    """Convert linear HDR (H, W, 3) to display uint8 (no extra gamma — the
    reference presents its tone-mapped output directly to an sRGB-naive
    R8G8B8A8_UNORM swap chain)."""
    return np.clip(np.round(np.asarray(rgb_linear, np.float32) * 255.0),
                   0, 255).astype(np.uint8)
