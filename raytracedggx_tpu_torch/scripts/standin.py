"""Procedural stand-in scenes for the port's drives and benches.

The reference's benches load ``bunny.obj``, which is in neither the repo
nor the machines that run the port, so the port renders a deterministic
model of the bunny's scale instead: an icosphere subdivided 6 times
(81,920 triangles), radially displaced by a fixed smooth function of
direction, over the ground cube.  ``write_obj`` writes a mesh as an OBJ
file that ``io/obj.load_obj`` reads back as the same mesh, for the CLI.
"""

from __future__ import annotations

import numpy as np


def model_mesh(subdiv: int = 6):
    """Icosphere subdivided ``subdiv`` times (20 * 4**subdiv triangles),
    radially displaced by a fixed smooth function of direction, with
    area-weighted smooth vertex normals."""
    from ..scene import Mesh

    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
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
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    r = 1.0 + 0.12 * np.sin(4.0 * x + 1.0) * np.cos(3.0 * y) \
        + 0.08 * np.sin(6.0 * z + 2.0 * x)
    pos = v * r[:, None]
    fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, f[:, k], fn)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return Mesh(pos.astype(np.float32), nrm.astype(np.float32),
                f.reshape(-1).astype(np.uint32))


def model_scene(subdiv: int = 6):
    """The ground cube and the stand-in model at ``pos_scale`` (0, 1, 0, 1)."""
    from ..scene import Scene, default_materials, ground_cube

    return Scene(meshes=[ground_cube(), model_mesh(subdiv)],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 1.0, 0.0, 1.0], np.float32))


def nested_scene():
    """The 9-instance scene of tests/test_scene_wide.py (nested top tree)."""
    from ..scene import Scene, default_materials, ground_cube

    extra = tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
                  for i in range(7))
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                 extra_instances=extra)


def write_obj(path, mesh):
    """Write a Mesh as a Wavefront OBJ (``v``, ``vn``, ``f v//vn``) that
    ``load_obj``'s DirectX conversion (z negated, the index buffer
    reversed) reads back as this mesh: z is written negated and the
    index buffer reversed, and each vertex has its own normal (no vertex
    splits).  Nine significant digits keep every float32 exact."""
    pos = np.asarray(mesh.positions, np.float32) * np.float32([1, 1, -1])
    nrm = np.asarray(mesh.normals, np.float32) * np.float32([1, 1, -1])
    idx = np.asarray(mesh.indices, np.int64)[::-1].reshape(-1, 3) + 1
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pos)
        f.writelines(f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in nrm)
        f.writelines(f"f {a}//{a} {b}//{b} {c}//{c}\n" for a, b, c in idx)
