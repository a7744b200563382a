"""Wavefront OBJ loader with XUSG ObjLoader-compatible semantics.

Replicates the behavior of the reference loader
(the reference's RayTracedGGX/XUSG/Optional/XUSGObjLoader.cpp):

- face formats v, v//vn, v/vt, v/vt/vn; polygon faces fan-triangulated
  (loadIndices, XUSGObjLoader.cpp:231-298); negative indices wrap.
- DirectX handedness conversion (forDX=true): positions/normals negate z
  (XUSGObjLoader.cpp:191-216) and the *entire flat index array* is reversed
  (XUSGObjLoader.cpp:227) — this flips winding and reverses triangle order,
  which matters for primitive-id parity in the visibility buffer.
- if the file has normals, they are attached per-vertex with vertex
  splitting on conflicting (position, normal) pairs in first-occurrence
  order (computePerVertexNormals, XUSGObjLoader.cpp:302-337).
- else normals are recomputed: per-face normal cross(v1-v0, v2-v1)
  normalized, accumulated per vertex, then normalized
  (recomputeNormals, XUSGObjLoader.cpp:339-385). NOT area-weighted: each
  face contributes its unit normal.
- AABB over positions (computeAABB, XUSGObjLoader.cpp:387-420).

The output is numpy: positions (V,3) f32, normals (V,3) f32, indices (3T,)
u32.  Texcoords are parsed but unused by the renderer (the reference derives
procedural UVs at shade time, Material.hlsli:16-23).  Copied from
raytracedggx_tpu/io/obj.py (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ObjMesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32
    indices: np.ndarray    # (3T,) uint32
    aabb_min: np.ndarray   # (3,) float32
    aabb_max: np.ndarray   # (3,) float32

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


def _parse_face_token(tok: str, nv: int, nt: int, nn: int):
    """Return (v, vt, vn) 0-based indices (vt/vn = -1 if absent)."""
    parts = tok.split("/")
    v = int(parts[0])
    v = v + nv if v < 0 else v - 1
    vt = vn = -1
    if len(parts) >= 2 and parts[1]:
        t = int(parts[1])
        vt = t + nt if t < 0 else t - 1
    if len(parts) >= 3 and parts[2]:
        n = int(parts[2])
        vn = n + nn if n < 0 else n - 1
    return v, vt, vn


def load_obj(path: str, need_norm: bool = True, for_dx: bool = True,
             swap_yz: bool = False) -> ObjMesh:
    positions = []
    file_normals = []
    num_texc = 0
    face_tokens = []  # list of token lists per face

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line:
                continue
            c = line[0]
            if c == "v":
                if line[1] in " \t":
                    s = line.split()
                    positions.append((float(s[1]), float(s[2]), float(s[3])))
                elif line[1] == "n":
                    s = line.split()
                    file_normals.append((float(s[1]), float(s[2]), float(s[3])))
                elif line[1] == "t":
                    num_texc += 1  # only needed for negative vt references
            elif c == "f":
                face_tokens.append(line.split()[1:])

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm_file = (np.asarray(file_normals, np.float32).reshape(-1, 3)
                if file_normals else None)

    if swap_yz:
        pos = pos[:, [0, 2, 1]].copy()
        if nrm_file is not None:
            nrm_file = nrm_file[:, [0, 2, 1]].copy()
    if for_dx:
        pos[:, 2] = -pos[:, 2]
        if nrm_file is not None:
            nrm_file[:, 2] = -nrm_file[:, 2]

    nv, nt, nn = len(pos), num_texc, len(file_normals)

    v_idx, n_idx = [], []
    for toks in face_tokens:
        tri = [_parse_face_token(t, nv, nt, nn) for t in toks]
        # fan triangulation (XUSGObjLoader.cpp:266-297)
        for k in range(1, len(tri) - 1):
            for j in (0, k, k + 1):
                v_idx.append(tri[j][0])
                n_idx.append(tri[j][2])

    indices = np.asarray(v_idx, np.uint32)
    nrm_indices = np.asarray(n_idx, np.int64)

    # DX conversion reverses the whole flat index buffer
    # (XUSGObjLoader.cpp:227): flips winding AND triangle order.
    if (for_dx and not swap_yz) or (not for_dx and swap_yz):
        indices = indices[::-1].copy()
        nrm_indices = nrm_indices[::-1].copy()

    if nrm_file is not None and nn > 0:
        pos, normals, indices = _attach_file_normals(
            pos, nrm_file, indices, nrm_indices)
    elif need_norm:
        normals = _recompute_normals(pos, indices)
    else:
        normals = np.zeros_like(pos)

    return ObjMesh(
        positions=pos,
        normals=normals,
        indices=indices,
        aabb_min=pos.min(axis=0),
        aabb_max=pos.max(axis=0),
    )


def _attach_file_normals(pos, nrm_file, indices, nrm_indices):
    """Vectorized equivalent of computePerVertexNormals' sequential
    vertex-splitting (XUSGObjLoader.cpp:302-337): the first (v, n) pair
    encountered keeps vertex slot v; every later distinct pair for the same
    v gets a fresh vertex appended in first-occurrence order."""
    num_idx = len(indices)
    v = indices.astype(np.int64)
    n = nrm_indices

    # first occurrence order of distinct (v, n) pairs
    pair_key = v * (n.max() + 2) + n  # unique key per pair
    _, first_pos, inv = np.unique(pair_key, return_index=True,
                                  return_inverse=True)
    # order pairs by first occurrence in the index stream
    order = np.argsort(first_pos, kind="stable")
    rank_of_unique = np.empty_like(order)
    rank_of_unique[order] = np.arange(len(order))
    pair_rank = rank_of_unique[inv]  # for each index slot: pair occurrence rank

    first_pos_sorted = first_pos[order]
    pv = v[first_pos_sorted]   # vertex id per pair (in first-occurrence order)
    pn = n[first_pos_sorted]   # normal id per pair

    # the first pair for each vertex keeps the original slot
    seen = np.zeros(len(pos), bool)
    keeps = np.zeros(len(pv), bool)
    # vectorize "first pair per vertex in order": mark the pair with the
    # minimal rank per vertex
    first_rank_per_vertex = np.full(len(pos), np.iinfo(np.int64).max)
    np.minimum.at(first_rank_per_vertex, pv, np.arange(len(pv)))
    keeps = np.arange(len(pv)) == first_rank_per_vertex[pv]
    seen[pv[keeps]] = True

    new_pairs = np.flatnonzero(~keeps)
    slot = np.empty(len(pv), np.int64)
    slot[keeps] = pv[keeps]
    slot[new_pairs] = len(pos) + np.arange(len(new_pairs))

    out_pos = np.concatenate([pos, pos[pv[new_pairs]]], axis=0)
    out_nrm = np.zeros_like(out_pos)
    nrm_unit = nrm_file / np.maximum(
        np.linalg.norm(nrm_file, axis=1, keepdims=True), 1e-30)
    out_nrm[slot] = nrm_unit[pn]

    new_indices = slot[pair_rank].astype(np.uint32)
    return out_pos.astype(np.float32), out_nrm.astype(np.float32), new_indices


def _recompute_normals(pos, indices):
    """recomputeNormals (XUSGObjLoader.cpp:339-385): per-face unit normal
    accumulated to each of the 3 vertices, then per-vertex normalized."""
    tri = indices.reshape(-1, 3).astype(np.int64)
    v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v1
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
    out = np.zeros_like(pos)
    for j in range(3):
        np.add.at(out, tri[:, j], fn)
    out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-30)
    return out.astype(np.float32)
