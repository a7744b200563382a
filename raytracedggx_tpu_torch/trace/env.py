"""HDR environment cube map: storage + SampleLevel-style sampling.

Torch port of raytracedggx_tpu/trace/env.py (RayTracing.hlsl:170-178,
416-422): D3D cube-map face selection, bilinear within a face, trilinear
across mips, texels clamped at face edges.  The packed tables keep the
reference's storage types — ``quad`` (N, 12) float32 and ``tri`` (N, 39)
float16 — so lookups gather the same stored values (the f16 rows are
gathered in f16 and computed on in f32).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..utils.math3d import const


class EnvMap(NamedTuple):
    data: torch.Tensor     # (N, 3) float32: all mips, faces row-major
    offsets: torch.Tensor  # (L,) int64 start of each mip in data
    sizes: torch.Tensor    # (L,) int64 face edge length per mip
    num_mips: int
    quad: torch.Tensor     # (N, 12) float32 edge-clamped 2x2 footprints
    tri: torch.Tensor      # (N, 39) float16: own quad | parent 3x3 window
    sizes_host: tuple      # sizes and offsets as python ints, so a lookup
    offsets_host: tuple    # at a python mip reads no device tensor


def _pack_tables(mips: List[np.ndarray]):
    """numpy (data, offsets, sizes, quad, tri) — as the reference's
    pack_mips builds them."""
    offsets, sizes, chunks, quads, tris = [], [], [], [], []
    off = 0
    for mi, m in enumerate(mips):
        s = m.shape[1]
        assert m.shape == (6, s, s, 3)
        offsets.append(off)
        sizes.append(s)
        m = np.asarray(m, np.float32)
        chunks.append(m.reshape(-1, 3))
        x1 = np.minimum(np.arange(s) + 1, s - 1)
        quad = np.concatenate(
            [m, m[:, :, x1], m[:, x1, :], m[:, x1][:, :, x1]],
            axis=-1).reshape(-1, 12)
        quads.append(quad)
        # parent-mip 3x3 window around (y0//2, x0//2) per texel
        par = np.asarray(mips[min(mi + 1, len(mips) - 1)], np.float32)
        s2 = par.shape[1]
        k = np.arange(s) // 2
        win = []
        for r in (-1, 0, 1):
            yy = np.clip(k + r, 0, s2 - 1)
            for c in (-1, 0, 1):
                xx = np.clip(k + c, 0, s2 - 1)
                win.append(par[:, yy][:, :, xx])
        tris.append(np.concatenate([quad.reshape(6, s, s, 12)] + win,
                                   axis=-1).reshape(-1, 39))
        off += 6 * s * s
    return (np.concatenate(chunks, axis=0), np.asarray(offsets),
            np.asarray(sizes), np.concatenate(quads, axis=0),
            np.concatenate(tris, axis=0).astype(np.float16))


def from_reference_arrays(data, offsets, sizes, num_mips, quad, tri,
                          device=None) -> EnvMap:
    """EnvMap from the reference EnvMap's arrays as numpy (the probe
    carried across unchanged, dtypes kept)."""
    def dev(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return EnvMap(data=dev(data, torch.float32),
                  offsets=dev(offsets, torch.int64),
                  sizes=dev(sizes, torch.int64),
                  num_mips=int(num_mips),
                  quad=dev(quad, torch.float32),
                  tri=dev(tri, torch.float16),
                  sizes_host=tuple(int(x) for x in np.array(sizes)),
                  offsets_host=tuple(int(x) for x in np.array(offsets)))


def pack_mips(mips: List[np.ndarray], device=None) -> EnvMap:
    """mips[m]: (6, S_m, S_m, 3), S_m halving per level down to 1."""
    data, offsets, sizes, quad, tri = _pack_tables(mips)
    return from_reference_arrays(data, offsets, sizes, len(mips), quad, tri,
                                 device=device)


def build_mips(base: np.ndarray) -> List[np.ndarray]:
    """2x2 box-filter mip chain from a (6, S, S, 3) base down to 1x1."""
    mips = [np.asarray(base, np.float32)]
    while mips[-1].shape[1] > 1:
        m = mips[-1]
        s = m.shape[1] // 2
        mips.append(m.reshape(6, s, 2, s, 2, 3).mean(axis=(2, 4)))
    return mips


def dir_to_face_uv(d):
    """D3D cube-map face selection + uv for (..., 3) directions.
    Returns (face int64, u, v) with u, v in [0, 1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                     torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    inv = 0.5 / torch.clamp(ma, min=1e-30)
    return face.to(torch.int64), sc * inv + 0.5, tc * inv + 0.5


def face_uv_to_dir(face: int, u, v):
    """Inverse mapping (texel center uv in [0,1] -> unit direction)."""
    sc = u * 2.0 - 1.0
    tc = v * 2.0 - 1.0
    one = torch.ones_like(sc)
    d = {0: (one, -tc, -sc), 1: (-one, -tc, sc), 2: (sc, one, tc),
         3: (sc, -one, -tc), 4: (sc, -tc, one), 5: (-sc, -tc, -one)}[face]
    d = torch.stack(d, dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _texel(u, v, sf):
    """Continuous texel coords clamped to [0, sf-1] -> (x0, y0, fx, fy);
    sf is a float32 tensor (scalar or per-lane)."""
    x = torch.minimum(torch.clamp(u * sf - 0.5, min=0.0), sf - 1.0)
    y = torch.minimum(torch.clamp(v * sf - 0.5, min=0.0), sf - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0, y0, (x - x0)[..., None], (y - y0)[..., None]


def _mix4(q, fx, fy):
    return (q[..., 0:3] * (1 - fx) * (1 - fy) + q[..., 3:6] * fx * (1 - fy)
            + q[..., 6:9] * (1 - fx) * fy + q[..., 9:12] * fx * fy)


def _bilinear(env: EnvMap, mip: int, face, u, v):
    """Bilinear sample of one mip level: one gather of the texel's
    edge-clamped 2x2 footprint row."""
    s, off = env.sizes_host[mip], env.offsets_host[mip]
    sf = u.new_full((), float(s))
    x0, y0, fx, fy = _texel(u, v, sf)
    idx = off + (face * s + y0.to(torch.int64)) * s + x0.to(torch.int64)
    return _mix4(env.quad[idx], fx, fy)


def mip_level(env: EnvMap, rough):
    """calcCubemapMipFromRoughness (RayTracing.hlsl:416-422): the mip a
    roughness samples, unclamped."""
    level = 3.0 - 1.15 * torch.log2(torch.clamp(rough, min=1e-20))
    return env.num_mips - 1.0 - level


def sample_env(env: EnvMap, d, level=0.0):
    """SampleLevel(dir, level): trilinear clamp.  d (..., 3); level a
    python number or a (...,) tensor.  An integral python level skips
    the second mip (the miss shader's level 0, RayTracing.hlsl:619-625)."""
    face, u, v = dir_to_face_uv(d)
    if not torch.is_tensor(level) and float(level) == int(level):
        m = int(np.clip(level, 0, env.num_mips - 1))
        return _bilinear(env, m, face, u, v)
    if not torch.is_tensor(level):
        level = u.new_full(face.shape, float(level))
    level = torch.clamp(level.to(torch.float32).expand(face.shape), 0.0,
                        env.num_mips - 1.0)
    m0 = torch.floor(level).to(torch.int64)
    f = (level - m0.to(torch.float32))[..., None]
    return _trilinear_packed(env, m0, f, face, u, v)


def _trilinear_packed(env: EnvMap, m0, f, face, u, v):
    """Trilinear via ONE gather of the packed (N, 39) f16 rows: the child
    quad serves mip m0's bilinear, the parent 3x3 window mip m0+1's."""
    s = env.sizes[m0]
    off = env.offsets[m0]
    sf = s.to(torch.float32)
    x0, y0, fx, fy = _texel(u, v, sf)
    idx = off + (face * s + y0.to(torch.int64)) * s + x0.to(torch.int64)
    row = env.tri[idx].to(torch.float32)
    c0 = _mix4(row, fx, fy)

    # parent-mip bilinear from the 3x3 window centred on column k = x0//2:
    # the parent sample column is k-1 or k
    s2 = torch.clamp(torch.floor(sf * 0.5), min=1.0)
    px = torch.minimum(torch.clamp(u * s2 - 0.5, min=0.0), s2 - 1.0)
    py = torch.minimum(torch.clamp(v * s2 - 0.5, min=0.0), s2 - 1.0)
    px0 = torch.floor(px)
    py0 = torch.floor(py)
    fxp = px - px0
    fyp = py - py0
    lo_x = (px0 - torch.floor(x0 * 0.5) + 1.0) < 0.5
    lo_y = (py0 - torch.floor(y0 * 0.5) + 1.0) < 0.5
    zero = torch.zeros_like(fxp)
    wx = (torch.where(lo_x, 1.0 - fxp, zero),
          torch.where(lo_x, fxp, 1.0 - fxp),
          torch.where(lo_x, zero, fxp))
    wy = (torch.where(lo_y, 1.0 - fyp, zero),
          torch.where(lo_y, fyp, 1.0 - fyp),
          torch.where(lo_y, zero, fyp))
    c1 = torch.zeros_like(c0)
    for r in range(3):
        for c in range(3):
            o = 12 + 3 * (r * 3 + c)
            c1 = c1 + row[..., o:o + 3] * (wy[r] * wx[c])[..., None]
    return c0 * (1 - f) + c1 * f


def procedural_sky(d):
    """The reference's built-in sky (RayTracing.hlsl:172-178): vertical
    gradient *3 + a hard sun disk along normalize(-1, 1, -1)."""
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    sun_dir = const((-1.0, 1.0, -1.0), d)
    sun_dir = sun_dir / torch.linalg.norm(sun_dir)
    sun_amt = torch.clamp(torch.sum(d * sun_dir, dim=-1), 0.0, 1.0)
    a = d[..., 1] * 0.5 + 0.5
    base = const((0.0, 0.16, 0.64), d)
    color = base + (1.0 - base) * a[..., None]
    return color * 3.0 + torch.where(sun_amt > 0.9995, 7.0, 0.0)[..., None]


def procedural_env(size: int = 64, device=None) -> EnvMap:
    """Bake the procedural sky into a cube map (the no-DDS fallback)."""
    uv = (torch.arange(size, dtype=torch.float64) + 0.5) / size
    v, u = torch.meshgrid(uv.float(), uv.float(), indexing="ij")
    base = torch.stack([procedural_sky(face_uv_to_dir(f, u, v))
                        for f in range(6)]).numpy()
    return pack_mips(build_mips(base), device=device)
