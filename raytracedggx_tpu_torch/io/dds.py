"""DDS container loader for cube-map environment probes.

Parses the DDS header (+ DX10 extension), decodes the supported texel
formats, and returns the full mip chain of all 6 faces.  Replaces the
binary-only XUSG DDS loader used at RayTracer.cpp:143-150 for the
`*_cross.dds` HDR probes (BC6H_UF16 cube maps with full mip chains).

Supported formats: BC6H_UF16/SF16 (via the native C++ decoder,
``io/native.py``), R32G32B32A32/R32G32B32/R16G16B16A16 float, and 8-bit
RGBA variants.  Copied from raytracedggx_tpu/io/dds.py; the EnvMap is the
port's (``trace/env.py``), on the caller's device.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

DDS_MAGIC = b"DDS "
DDSCAPS2_CUBEMAP = 0x200

DXGI_R32G32B32A32_FLOAT = 2
DXGI_R32G32B32_FLOAT = 6
DXGI_R16G16B16A16_FLOAT = 10
DXGI_R8G8B8A8_UNORM = 28
DXGI_BC6H_UF16 = 95
DXGI_BC6H_SF16 = 96


class DDSError(ValueError):
    pass


def _mip_dims(size: int, level: int) -> int:
    return max(1, size >> level)


def load_dds_cubemap(path: str) -> List[np.ndarray]:
    """Returns mips: list over levels of (6, S, S, 3) float32 arrays."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != DDS_MAGIC:
        raise DDSError(f"{path}: not a DDS file")
    (size, flags, height, width, pitch, depth, mips) = struct.unpack(
        "<7I", data[4:32])
    if size != 124:
        raise DDSError("bad header size")
    pf_flags, fourcc = struct.unpack("<2I", data[80:88])
    caps2 = struct.unpack("<I", data[112:116])[0]
    offset = 128
    dxgi = None
    if fourcc == struct.unpack("<I", b"DX10")[0]:
        dxgi, dim, misc, asize, misc2 = struct.unpack("<5I",
                                                      data[128:148])
        offset = 148
        is_cube = bool(misc & 0x4)
    else:
        is_cube = bool(caps2 & DDSCAPS2_CUBEMAP)
        if fourcc == 113:      # D3DFMT_A16B16G16R16F
            dxgi = DXGI_R16G16B16A16_FLOAT
        elif fourcc == 116:    # D3DFMT_A32B32G32R32F
            dxgi = DXGI_R32G32B32A32_FLOAT
    if not is_cube:
        raise DDSError(f"{path}: not a cube map")
    if mips == 0:
        mips = 1
    if height != width:
        raise DDSError("non-square cube faces")

    faces = [[None] * mips for _ in range(6)]
    pos = offset
    from .native import bc6h_decode

    for face in range(6):
        for level in range(mips):
            s = _mip_dims(width, level)
            if dxgi in (DXGI_BC6H_UF16, DXGI_BC6H_SF16):
                bw = max(1, (s + 3) // 4)
                nbytes = bw * bw * 16
                blocks = np.frombuffer(data, np.uint8, nbytes, pos)
                texels = bc6h_decode(blocks.reshape(-1, 16),
                                     dxgi == DXGI_BC6H_SF16)
                # blocks raster over 4x4 tiles
                img = texels.reshape(bw, bw, 4, 4, 3).transpose(
                    0, 2, 1, 3, 4).reshape(bw * 4, bw * 4, 3)
                img = img[:s, :s]
            elif dxgi == DXGI_R32G32B32A32_FLOAT:
                nbytes = s * s * 16
                img = np.frombuffer(data, np.float32, s * s * 4, pos
                                    ).reshape(s, s, 4)[..., :3]
            elif dxgi == DXGI_R32G32B32_FLOAT:
                nbytes = s * s * 12
                img = np.frombuffer(data, np.float32, s * s * 3, pos
                                    ).reshape(s, s, 3)
            elif dxgi == DXGI_R16G16B16A16_FLOAT:
                nbytes = s * s * 8
                img = np.frombuffer(data, np.float16, s * s * 4, pos
                                    ).reshape(s, s, 4)[..., :3
                                                       ].astype(np.float32)
            elif dxgi == DXGI_R8G8B8A8_UNORM:
                nbytes = s * s * 4
                img = (np.frombuffer(data, np.uint8, s * s * 4, pos)
                       .reshape(s, s, 4)[..., :3].astype(np.float32) / 255.0)
            else:
                raise DDSError(f"unsupported DDS format {dxgi}/{fourcc}")
            faces[face][level] = np.ascontiguousarray(img, np.float32)
            pos += nbytes

    return [np.stack([faces[f][lvl] for f in range(6)])
            for lvl in range(mips)]


def load_cubemap_env(path: str, device=None):
    """Load a DDS cube map straight into a sampleable EnvMap on
    ``device``."""
    from ..trace.env import build_mips, pack_mips

    mips = load_dds_cubemap(path)
    if len(mips) == 1 and mips[0].shape[1] > 1:
        mips = build_mips(mips[0])
    return pack_mips(mips, device=device)
