"""The procedural stand-in model, drawn from the run's seed.

A unit icosphere, radially displaced by a smooth function of direction,
with area-weighted vertex normals (the port's
``scripts/standin.model_mesh``, frozen here).  Two tessellations of the
icosahedron give it its triangle count:

- ``midpoint``: every triangle split in four, ``level`` times, each new
  vertex pushed out to the sphere (20 * 4**level triangles; the port's
  own stand-in);
- ``geodesic``: every face cut by a grid of ``level`` steps a side and the
  grid's points pushed out to the sphere (20 * level**2 triangles), for a
  count between two midpoint levels.

The triangle count and topology are fixed by the tessellation; the seed
moves only the three phases of the displacement.  ``write_obj`` writes
the model as an OBJ that the port's loader reads back as these very
arrays (z negated and the index buffer reversed, the DirectX conversion,
undone; nine significant digits keep every float32).
"""

from __future__ import annotations

import numpy as np

TESSELLATIONS = ("midpoint", "geodesic")


def triangles(tessellation: str, level: int) -> int:
    """The triangle count of a tessellation at ``level``."""
    if tessellation == "midpoint":
        return 20 * 4 ** level
    if tessellation == "geodesic":
        return 20 * level ** 2
    raise ValueError(f"no tessellation {tessellation!r}")


def icosahedron():
    """(12 unit vertices (float64), 20 faces, counter-clockwise seen from
    outside)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return v / np.linalg.norm(v, axis=1, keepdims=True), f


def midpoint_sphere(level: int):
    """(unit vertices, faces): the icosahedron split ``level`` times."""
    v, f = icosahedron()
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = inv.reshape(3, -1) + len(v)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[0], m[1], m[2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                            np.stack([ca, bc, c], 1),
                            np.stack([ab, bc, ca], 1)])
        v = np.concatenate([v, mid])
    return v, f


def geodesic_sphere(level: int):
    """(unit vertices, faces): each icosahedron face (A, B, C) cut into
    level**2 triangles by the points (A (n - i - j) + B i + C j) / n,
    n = level.  A point on an edge or corner is shared: it is keyed by its
    weights on the 12 corners, so both faces give the same vertex."""
    corners, faces = icosahedron()
    n = int(level)
    ii, jj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    keep = ii + jj <= n
    ii, jj = ii[keep], jj[keep]                     # the grid of one face
    grid = -np.ones((n + 1, n + 1), np.int64)
    grid[ii, jj] = np.arange(len(ii))
    weights = np.zeros((len(faces), len(ii), len(corners)), np.int64)
    for k, (a, b, c) in enumerate(faces):
        weights[k, :, a], weights[k, :, b], weights[k, :, c] = \
            n - ii - jj, ii, jj
    uniq, inv = np.unique(weights.reshape(-1, len(corners)), axis=0,
                          return_inverse=True)
    v = uniq.astype(np.float64) @ corners
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    idx = inv.reshape(len(faces), len(ii))
    ui, uj = np.nonzero(np.add.outer(np.arange(n), np.arange(n)) <= n - 1)
    di, dj = np.nonzero(np.add.outer(np.arange(n), np.arange(n)) <= n - 2)
    local = np.concatenate([
        np.stack([grid[ui, uj], grid[ui + 1, uj], grid[ui, uj + 1]], 1),
        np.stack([grid[di + 1, dj], grid[di + 1, dj + 1], grid[di, dj + 1]],
                 1)])
    f = np.concatenate([idx[k][local] for k in range(len(faces))])
    return v, f


def model_arrays(level: int, phases=(1.0, 0.0, 0.0),
                 tessellation: str = "midpoint"):
    """(positions (V, 3) f32, normals (V, 3) f32, indices (3T,) u32).
    phases (a, b, c): r = 1 + 0.12 sin(4x + a) cos(3y + b)
    + 0.08 sin(6z + 2x + c); the port's own model is (1, 0, 0) on the
    midpoint tessellation."""
    if tessellation == "midpoint":
        v, f = midpoint_sphere(level)
    elif tessellation == "geodesic":
        v, f = geodesic_sphere(level)
    else:
        raise ValueError(f"no tessellation {tessellation!r}")
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    pa, pb, pc = (float(p) for p in phases)
    r = 1.0 + 0.12 * np.sin(4.0 * x + pa) * np.cos(3.0 * y + pb) \
        + 0.08 * np.sin(6.0 * z + 2.0 * x + pc)
    pos = v * r[:, None]
    fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, f[:, k], fn)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            f.reshape(-1).astype(np.uint32))


def write_obj(path, arrays):
    """Write (positions, normals, indices) as a Wavefront OBJ (``v``,
    ``vn``, ``f v//vn``) in the file's right-handed convention."""
    pos, nrm, idx = arrays
    pos = np.asarray(pos, np.float32) * np.float32([1, 1, -1])
    nrm = np.asarray(nrm, np.float32) * np.float32([1, 1, -1])
    tri = np.asarray(idx, np.int64)[::-1].reshape(-1, 3) + 1
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pos)
        f.writelines(f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in nrm)
        f.writelines(f"f {a}//{a} {b}//{b} {c}//{c}\n" for a, b, c in tri)
