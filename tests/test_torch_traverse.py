"""PyTorch port parity, the per-mesh acceleration structures and traversals
(kernels K4 and K5 and what feeds them).

- ``build_lbvh`` / ``refit_lbvh``, ``flatten_bvh`` / ``refit_flat_bvh`` and
  ``flatten_bvh4`` must give the JAX package's arrays EXACTLY, after the
  layout change ((Nt, 9|36, 128) lane columns -> (N, 9|36) rows); K4's
  float4 copies (``pairs``, ``tris4``) and depth hold those
  rows, and a float32 emulation of K4's near-first walk over the pair rows
  returns the DFS walk's hits, exact-t ties included.
- The plain versions of K4 and K5 (the brute-force oracle over the
  stream-ordered triangles), fed the reference's own trees through
  ``from_reference_arrays``, must match the JAX kernels (Pallas in
  interpret mode) at the bar of tests/test_pallas_traverse.py:58-63,136-143
  and tests/test_scene_wide.py:56-63: exact hit mask, t at rtol 1e-4 /
  atol 1e-5, (inst, prim) on >= 99% of hits, rays with t_max < 0 missing.
- The wavefront traversal, the oracle, the intersection tests, the NDC
  barycentrics and the storage formats match their references.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.bvh import build_lbvh as j_build_lbvh
from raytracedggx_tpu.bvh import build_tlas as j_build_tlas
from raytracedggx_tpu.bvh import refit_lbvh as j_refit_lbvh
from raytracedggx_tpu.ops import flatten_bvh as j_flatten
from raytracedggx_tpu.ops import refit_flat_bvh as j_refit_flat
from raytracedggx_tpu.ops import trace_rays_pallas as j_trace_flat
from raytracedggx_tpu.ops import trace_scene_pallas as j_scene_flat
from raytracedggx_tpu.ops.wide import flatten_bvh4 as j_flatten4
from raytracedggx_tpu.ops.wide import trace_rays_pallas4 as j_trace4
from raytracedggx_tpu.ops.wide import trace_scene_pallas4 as j_scene4
from raytracedggx_tpu.trace import intersect as j_intersect
from raytracedggx_tpu.trace import traverse as j_traverse
from raytracedggx_tpu.trace.raygen import calc_barycentrics as j_bary
from raytracedggx_tpu.utils import formats as j_formats

from raytracedggx_tpu_torch.bvh import build_lbvh, refit_lbvh
from raytracedggx_tpu_torch.bvh.lbvh import clz32
from raytracedggx_tpu_torch.bvh.tlas import TLAS
from raytracedggx_tpu_torch.ops import flatten as t_flatten
from raytracedggx_tpu_torch.ops import wide as t_wide
from raytracedggx_tpu_torch.ops.traverse_cuda import (trace_rays_flat,
                                                      trace_scene_flat)
from raytracedggx_tpu_torch.trace import intersect, traverse
from raytracedggx_tpu_torch.trace.raygen import calc_barycentrics
from raytracedggx_tpu_torch.utils import formats


def random_tris(rng, n, spread=6.0):
    """tests/test_pallas_traverse.py:random_tris."""
    base = (rng.random((n, 1, 3)) - 0.5) * 2 * spread
    v = (base + (rng.random((n, 3, 3)) - 0.5)).astype(np.float32)
    return v.reshape(-1, 3), np.arange(3 * n, dtype=np.uint32)


def mt_data(pos, idx):
    """(v0, e1, e2) numpy (T, 3) in original triangle order."""
    tri = pos[idx.reshape(-1, 3).astype(np.int64)]
    return tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]


def rand_rays(rng, n, spread):
    o = ((rng.random((n, 3)) - 0.5) * spread).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def t_(x):
    return torch.as_tensor(np.array(x))


def hold_to_bar(got, ref, t_max):
    """Hit mask exact, t at rtol 1e-4 / atol 1e-5, (inst, prim) on >= 99%
    of hits, no ray with t_max < 0 hits."""
    h = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    assert h.any()
    assert not got.hit.numpy()[np.asarray(t_max) < 0].any()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                               rtol=1e-4, atol=1e-5)
    same = ((got.prim.numpy() == np.asarray(ref.prim))
            & (got.inst.numpy() == np.asarray(ref.inst)))[h]
    assert same.mean() >= 0.99


def test_clz32_is_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.integers(0, 1 << 32, size=4000, dtype=np.int64),
        [0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
        1 << np.arange(32, dtype=np.int64),
        (1 << np.arange(1, 33, dtype=np.int64)) - 1])
    want = np.array([32 - int(v).bit_length() for v in x])
    np.testing.assert_array_equal(clz32(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("dup", [False, True])
def test_lbvh_build_and_refit_equal_reference(dup):
    """Same topology and boxes; ``dup`` repeats triangles so that equal
    Morton codes exercise the stable sort and the index tie-break."""
    rng = np.random.default_rng(5)
    pos, idx = random_tris(rng, 130)
    if dup:
        pos = np.concatenate([pos, pos[:90], pos[:45]])
        idx = np.arange(pos.shape[0], dtype=np.uint32)
    ref = j_build_lbvh(pos, idx)
    got = build_lbvh(pos, idx)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pos2 = pos * 1.3 + np.array([2.0, -1.0, 0.5], np.float32)
    ref2 = j_refit_lbvh(ref, pos2, idx)
    got2 = refit_lbvh(got, pos2, idx)
    for a, b in zip(got2, ref2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
def test_flatten_and_flatten4_equal_reference(leaf_size):
    rng = np.random.default_rng(11 + leaf_size)
    pos, idx = random_tris(rng, 130)
    v0, e1, e2 = mt_data(pos, idx)
    jb = j_build_lbvh(pos, idx)
    tb = build_lbvh(pos, idx)

    ref = j_flatten(jb, v0, e1, e2, leaf_size=leaf_size)
    got = t_flatten.flatten_bvh(tb, t_(v0), t_(e1), t_(e2),
                                leaf_size=leaf_size)
    want = t_flatten.from_reference_arrays(
        *(np.asarray(x) for x in (ref.nodes, ref.tris, ref.tri_perm)),
        ref.num_nodes,
        *(np.asarray(x) for x in (ref.refit_level, ref.refit_a,
                                  ref.refit_b)))
    assert got.num_nodes == want.num_nodes
    for name in ("nodes", "tris", "tri_perm", "refit_level", "refit_a",
                 "refit_b", "links"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)

    ref4 = j_flatten4(jb, v0, e1, e2, leaf_size=leaf_size)
    got4 = t_wide.flatten_bvh4(tb, t_(v0), t_(e1), t_(e2),
                               leaf_size=leaf_size)
    want4 = t_wide.from_reference_arrays(
        np.asarray(ref4.nodes), np.asarray(ref4.tris),
        np.asarray(ref4.tri_perm), ref4.num_nodes)
    assert (got4.num_nodes, got4.stack) == (want4.num_nodes, want4.stack)
    for name in ("nodes", "tris", "tri_perm"):
        np.testing.assert_array_equal(getattr(got4, name).numpy(),
                                      getattr(want4, name).numpy(), name)


@pytest.mark.parametrize("leaf_size", [1, 8])
def test_wide_tris4_pads_each_vector(leaf_size):
    """``WideBVH.tris4``, K5's float4 copy of the triangle rows, holds the
    (T, 9) rows with a zero after each of v0, e1, e2, from both
    ``flatten_bvh4`` and ``from_reference_arrays``; the trees it sits
    beside stay the reference's bit for bit."""
    rng = np.random.default_rng(31 + leaf_size)
    pos, idx = random_tris(rng, 150)
    v0, e1, e2 = mt_data(pos, idx)
    ref4 = j_flatten4(j_build_lbvh(pos, idx), v0, e1, e2,
                      leaf_size=leaf_size)
    got4 = t_wide.flatten_bvh4(build_lbvh(pos, idx), t_(v0), t_(e1),
                               t_(e2), leaf_size=leaf_size)
    want4 = t_wide.from_reference_arrays(
        np.asarray(ref4.nodes), np.asarray(ref4.tris),
        np.asarray(ref4.tri_perm), ref4.num_nodes)
    for w in (got4, want4):
        assert w.tris4.dtype == torch.float32 and w.tris4.is_contiguous()
        assert w.tris4.shape == (w.tris.shape[0], 12)
        rows = w.tris4.numpy().reshape(-1, 3, 4)
        np.testing.assert_array_equal(rows[..., :3].reshape(-1, 9),
                                      w.tris.numpy())
        assert not rows[..., 3].any()
    for name in ("nodes", "tris", "tris4", "tri_perm"):
        np.testing.assert_array_equal(getattr(got4, name).numpy(),
                                      getattr(want4, name).numpy(), name)
    np.testing.assert_array_equal(
        got4.tris.numpy(),
        t_flatten.lane_rows(ref4.tris, len(ref4.tri_perm), 9))


def _depth(node, left, right, n_int, leaf_size):
    """Nodes on the longest root-to-leaf path of the flattened tree,
    counted on the LBVH by recursion (subtrees of at most leaf_size
    triangles collapse into one leaf)."""
    def count(v):
        return 1 if v >= n_int else count(left[v]) + count(right[v])

    if node >= n_int or count(node) <= leaf_size:
        return 1
    return 1 + max(_depth(left[node], left, right, n_int, leaf_size),
                   _depth(right[node], left, right, n_int, leaf_size))


def _check_k4_rows(flat):
    """FlatBVH's float4 copies against its (N, 9) / (T, 9) rows: tris4
    pads each vector with a 0; pair row 1 + k holds the k-th
    internal node's children i + 1 and skip(i + 1), row 0 the root beside
    a NaN box with count -1."""
    nodes, tris = flat.nodes.numpy(), flat.tris.numpy()
    assert flat.tris4.dtype == torch.float32 and flat.tris4.is_contiguous()
    r = flat.tris4.numpy().reshape(-1, 3, 4)
    np.testing.assert_array_equal(r[..., :3].reshape(-1, 9), tris)
    assert not r[..., 3].any()
    inner = [i for i in range(flat.num_nodes) if nodes[i, 8] == 0]
    row_of = {i: 1 + k for k, i in enumerate(inner)}

    def slot(c):
        link = ((nodes[c, 7], nodes[c, 8]) if nodes[c, 8] > 0
                else (row_of[c], 0.0))
        return [*nodes[c, :6], *link]

    want = []
    for i in [None, *inner]:
        if i is None:
            a, b = slot(0), [np.nan] * 6 + [0.0, -1.0]
        else:
            a, b = slot(i + 1), slot(int(nodes[i + 1, 6]))
        want.append(a[:6] + b[:6] + a[6:] + b[6:])
    assert flat.pairs.is_contiguous()
    np.testing.assert_array_equal(flat.pairs.numpy(),
                                  np.array(want, np.float32))


@pytest.mark.parametrize("leaf_size", [1, 8])
def test_flat_k4_rows_hold_the_node_rows(leaf_size):
    """K4's copies and depth from ``flatten_bvh`` and from
    ``from_reference_arrays`` (the reference's tree) agree with their own
    (N, 9) / (T, 9) rows, with each other, and the depth with a recursive
    count on the LBVH."""
    rng = np.random.default_rng(41 + leaf_size)
    pos, idx = random_tris(rng, 140)
    v0, e1, e2 = mt_data(pos, idx)
    ref = j_flatten(j_build_lbvh(pos, idx), v0, e1, e2, leaf_size=leaf_size)
    tb = build_lbvh(pos, idx)
    got = t_flatten.flatten_bvh(tb, t_(v0), t_(e1), t_(e2),
                                leaf_size=leaf_size)
    want = t_flatten.from_reference_arrays(
        *(np.asarray(x) for x in (ref.nodes, ref.tris, ref.tri_perm)),
        ref.num_nodes,
        *(np.asarray(x) for x in (ref.refit_level, ref.refit_a,
                                  ref.refit_b)))
    for f in (got, want):
        _check_k4_rows(f)
    left, right = tb.left.numpy(), tb.right.numpy()
    depth = _depth(0, left, right, len(left), leaf_size)
    assert got.stack == want.stack == depth > 5
    for name in ("pairs", "tris4"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)


def test_refit_flat_bvh_equals_reference():
    rng = np.random.default_rng(97)
    pos, idx = random_tris(rng, 97)
    v0, e1, e2 = mt_data(pos, idx)
    ref = j_flatten(j_build_lbvh(pos, idx), v0, e1, e2, leaf_size=4)
    got = t_flatten.flatten_bvh(build_lbvh(pos, idx), t_(v0), t_(e1),
                                t_(e2), leaf_size=4)
    pos2 = pos * 1.3 + np.array([2.0, -1.0, 0.5], np.float32)
    ref2 = j_refit_flat(ref, pos2, idx)
    got2 = t_flatten.refit_flat_bvh(got, pos2, idx)
    N, T = got2.num_nodes, got2.tris.shape[0]
    np.testing.assert_array_equal(
        got2.nodes.numpy(), t_flatten.lane_rows(ref2.nodes, N, 9))
    np.testing.assert_array_equal(
        got2.tris.numpy(), t_flatten.lane_rows(ref2.tris, T, 9))
    # K4's copies follow the refitted rows (the depth stays)
    _check_k4_rows(got2)
    assert got2.stack == got.stack
    assert not np.array_equal(got2.pairs.numpy(), got.pairs.numpy())


def _box(o, inv, lo, hi, t_min, best_t):
    """K4's slab test in float32; fmin / fmax skip a NaN as CUDA's do."""
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn = np.fmax(np.fmax(np.fmin(t0[0], t1[0]), np.fmin(t0[1], t1[1])),
                 np.fmin(t0[2], t1[2]))
    tf = np.fmin(np.fmin(np.fmax(t0[0], t1[0]), np.fmax(t0[1], t1[1])),
                 np.fmax(t0[2], t1[2]))
    return bool((tn <= tf) & (tf >= t_min) & (tn <= best_t)), tn


def _uvt(o, d, tri, t_min):
    """Moller-Trumbore with an exact 1/det in float32: (ok, t, u, v)."""
    v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    p = np.cross(d, e2)
    inv_det = np.float32(1.0) / np.dot(e1, p)
    tv = o - v0
    u = np.dot(tv, p) * inv_det
    q = np.cross(tv, e1)
    v = np.dot(d, q) * inv_det
    t = np.dot(e2, q) * inv_det
    return bool((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min)), t, u, v


def _dfs_walk(flat, o, d, t_min, t_max):
    """The TPU kernel's walk: DFS order with skip links, a hit taken on
    t <= best_t.  Returns (t, u, v, stream position)."""
    nodes, tris = flat.nodes.numpy(), flat.tris.numpy()
    inv = np.float32(1.0) / d
    best = [t_max, np.float32(0), np.float32(0), -1]
    i = 0
    while t_max >= 0 and i < flat.num_nodes:
        skip, start, count = (int(x) for x in nodes[i, 6:9])
        hit, _ = _box(o, inv, nodes[i, 0:3], nodes[i, 3:6], t_min, best[0])
        if hit and count == 0:
            i += 1
            continue
        for j in range(start, start + count if hit else start):
            ok, t, u, v = _uvt(o, d, tris[j], t_min)
            if ok and t <= best[0]:
                best = [t, u, v, j]
        i = skip
    return tuple(best)


def _pairs_walk(flat, o, d, t_min, t_max, far_first=False):
    """K4's walk over the pair rows (csrc/traverse_flat.cu:
    trace_flat_pairs_kernel), its stack capped at the tree's depth: leaves
    at once, nearer first; descend into the nearer internal child, push
    the farther with its entry distance; a hit taken on t < best_t, or on
    t == best_t at a later stream position.  far_first visits the other
    child first, as a check that the result does not depend on the order.
    Returns ((t, u, v, stream position), deepest stack)."""
    pairs, tris = flat.pairs.numpy(), flat.tris.numpy()
    inv = np.float32(1.0) / d
    best = [t_max, np.float32(0), np.float32(0), -1]
    stack, deepest, row = [], 0, 0

    def leaf(a, c):
        nonlocal best
        for j in range(a, a + c):
            ok, t, u, v = _uvt(o, d, tris[j], t_min)
            if ok and (t < best[0] or (t == best[0] and j > best[3])):
                best = [t, u, v, j]

    while t_max >= 0:
        p = pairs[row]
        kids = []
        for k in (0, 1):
            hit, tn = _box(o, inv, p[6 * k:6 * k + 3], p[6 * k + 3:6 * k + 6],
                           t_min, best[0])
            kids.append((hit, tn, int(p[12 + 2 * k]), int(p[13 + 2 * k])))
        h1, tn1 = kids[1][:2]
        if h1 and (not kids[0][0] or (tn1 < kids[0][1]) != far_first):
            kids.reverse()
        (h0, tn0, a0, c0), (h1, tn1, a1, c1) = kids
        if h0 and c0 > 0:
            leaf(a0, c0)
        if h1 and c1 > 0 and tn1 <= best[0]:
            leaf(a1, c1)
        in0 = h0 and c0 == 0 and tn0 <= best[0]
        in1 = h1 and c1 == 0 and tn1 <= best[0]
        if in0:
            if in1:
                assert len(stack) < flat.stack    # no push is ever dropped
                stack.append((a1, tn1))
                deepest = max(deepest, len(stack))
            row = a0
            continue
        if in1:
            row = a1
            continue
        while stack and stack[-1][1] > best[0]:
            stack.pop()
        if not stack:
            break
        row = stack.pop()[0]
    return tuple(best), deepest


@pytest.mark.parametrize("leaf_size", [1, 8])
def test_pairs_walk_returns_the_dfs_walks_hits(leaf_size):
    """Every triangle twice (the copies tie at exactly the same t): K4's
    walk over the pair rows, near-first and far-first, returns the DFS
    walk's (t, u, v, stream position) on every ray, each hit the later
    stream position of its pair, and never needs more stack than the
    tree's depth less one."""
    rng = np.random.default_rng(60 + leaf_size)
    pos, _ = random_tris(rng, 24, spread=3.0)
    pos = np.concatenate([pos, pos])
    idx = np.arange(pos.shape[0], dtype=np.uint32)
    flat = t_flatten.flatten_bvh(build_lbvh(pos, idx),
                                 *(t_(x) for x in mt_data(pos, idx)),
                                 leaf_size=leaf_size)
    perm = flat.tri_perm.numpy()
    later = np.empty_like(perm)          # stream position -> its pair's last
    where = np.argsort(perm)
    n = len(perm) // 2
    for s_pos, tri_id in enumerate(perm):
        later[s_pos] = max(where[tri_id % n], where[tri_id % n + n])
    cents = pos.reshape(-1, 3, 3).mean(axis=1)
    R = 160
    o = rng.uniform(-8.0, 8.0, size=(R, 3)).astype(np.float32)
    aim = cents[rng.integers(0, len(cents), R)] + rng.normal(
        0.0, 0.02, size=(R, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    t_max = np.where(np.arange(R) % 7 == 3, -1.0, 1e4).astype(np.float32)
    t_max[::11] = 9.0                    # some rays end before their hit
    n_hit, deepest = 0, 0
    for r in range(R):
        want = _dfs_walk(flat, o[r], d[r], np.float32(1e-4), t_max[r])
        for far_first in (False, True):
            got, depth = _pairs_walk(flat, o[r], d[r], np.float32(1e-4),
                                     t_max[r], far_first)
            assert got == want, (r, far_first)
            deepest = max(deepest, depth)
        if want[3] >= 0:
            n_hit += 1
            assert want[3] == later[want[3]]
    assert n_hit > R // 2 and 0 < deepest < flat.stack


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_plain_matches_reference_kernel(kernel):
    """The port's plain K4/K5 on the reference's own tree against the JAX
    kernel in interpret mode, with per-ray t_max masking."""
    rng = np.random.default_rng(64)
    pos, idx = random_tris(rng, 220, spread=4.0)
    v0, e1, e2 = mt_data(pos, idx)
    jb = j_build_lbvh(pos, idx)
    R = 1024
    o, d = rand_rays(rng, R, 16.0)
    t_max = np.where(np.arange(R) % 5 == 0, -1.0, 1e4).astype(np.float32)
    if kernel == "K4":
        jt = j_flatten(jb, v0, e1, e2, leaf_size=4)
        ref = j_trace_flat(jt, jnp.asarray(o), jnp.asarray(d), 1e-4,
                           jnp.asarray(t_max), interpret=True)
        tree = t_flatten.from_reference_arrays(
            *(np.asarray(x) for x in (jt.nodes, jt.tris, jt.tri_perm)),
            jt.num_nodes, *(np.asarray(x) for x in (
                jt.refit_level, jt.refit_a, jt.refit_b)))
        got = trace_rays_flat(tree, t_(o), t_(d), 1e-4, t_(t_max))
    else:
        jt = j_flatten4(jb, v0, e1, e2, leaf_size=4)
        ref = j_trace4(jt, jnp.asarray(o), jnp.asarray(d), 1e-4,
                       jnp.asarray(t_max), interpret=True)
        tree = t_wide.from_reference_arrays(
            np.asarray(jt.nodes), np.asarray(jt.tris),
            np.asarray(jt.tri_perm), jt.num_nodes)
        got = t_wide.trace_rays4(tree, t_(o), t_(d), 1e-4, t_(t_max))
    hold_to_bar(got, ref, t_max)
    # the oracle on the original triangle order agrees too
    bf = traverse.trace_bruteforce(t_(v0), t_(e1), t_(e2), t_(o), t_(d),
                                   1e-4, t_(t_max))
    np.testing.assert_array_equal(bf.hit.numpy(), got.hit.numpy())


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_scene_loop_matches_reference(kernel):
    """trace_scene_flat / trace_scene4 (per-instance loop, best-t pruning,
    inst = i, prim through tri_perm) against trace_scene_pallas /
    trace_scene_pallas4 on two meshes in three instances."""
    rng = np.random.default_rng(9)
    meshes = [random_tris(rng, n, spread=3.0) for n in (60, 90)]
    mesh_ids = (0, 1, 0)
    worlds = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i, (ang, s, tx) in enumerate(((0.3, 1.0, -4.0), (1.1, 0.7, 0.0),
                                      (-0.8, 1.4, 4.5))):
        c, sn = np.cos(ang), np.sin(ang)
        worlds[i, :3, :3] = s * np.array([[c, 0, -sn], [0, 1, 0],
                                          [sn, 0, c]], np.float32)
        worlds[i, 3, :3] = (tx, 0.5 * i, 0.0)
    jbs = [j_build_lbvh(p, i) for p, i in meshes]
    tlas = j_build_tlas(jbs, jnp.asarray(worlds), mesh_ids=mesh_ids)
    R = 1024
    o, d = rand_rays(rng, R, 24.0)
    t_max = np.where(np.arange(R) % 4 == 3, -1.0, 1e4).astype(np.float32)
    if kernel == "K4":
        jt = [j_flatten(b, *mt_data(p, i), leaf_size=4)
              for b, (p, i) in zip(jbs, meshes)]
        ref = j_scene_flat(jt, tlas, jnp.asarray(o), jnp.asarray(d), 1e-4,
                           jnp.asarray(t_max), interpret=True)
        trees = [t_flatten.from_reference_arrays(
            *(np.asarray(x) for x in (f.nodes, f.tris, f.tri_perm)),
            f.num_nodes, *(np.asarray(x) for x in (
                f.refit_level, f.refit_a, f.refit_b))) for f in jt]
        scene_fn = trace_scene_flat
    else:
        jt = [j_flatten4(b, *mt_data(p, i), leaf_size=4)
              for b, (p, i) in zip(jbs, meshes)]
        ref = j_scene4(jt, tlas, jnp.asarray(o), jnp.asarray(d), 1e-4,
                       jnp.asarray(t_max), interpret=True)
        trees = [t_wide.from_reference_arrays(
            np.asarray(w.nodes), np.asarray(w.tris), np.asarray(w.tri_perm),
            w.num_nodes) for w in jt]
        scene_fn = t_wide.trace_scene4
    t_tlas = TLAS(*(t_(x) for x in (tlas.worlds, tlas.inv_worlds,
                                    tlas.aabb_min, tlas.aabb_max)),
                  mesh_ids=mesh_ids)
    got = scene_fn(trees, t_tlas, t_(o), t_(d), 1e-4, t_(t_max))
    hold_to_bar(got, ref, t_max)
    assert set(np.unique(got.inst.numpy()[got.hit.numpy()])) == {0, 1, 2}


def test_wavefront_traversal_and_oracle_match_reference():
    """trace_rays, trace_bruteforce and trace_scene (traversal="jax")."""
    rng = np.random.default_rng(21)
    pos, idx = random_tris(rng, 80)
    v0, e1, e2 = (jnp.asarray(x) for x in mt_data(pos, idx))
    R = 512
    o, d = rand_rays(rng, R, 24.0)
    jb = j_build_lbvh(pos, idx)
    tb = build_lbvh(pos, idx)
    ref = j_traverse.trace_rays(jb, v0, e1, e2, jnp.asarray(o),
                                jnp.asarray(d), 1e-4, 1e4)
    got = traverse.trace_rays(tb, t_(v0), t_(e1), t_(e2), t_(o), t_(d),
                              1e-4, 1e4)
    hold_to_bar(got, ref, np.full(R, 1e4))
    bf_ref = j_traverse.trace_bruteforce(v0, e1, e2, jnp.asarray(o),
                                         jnp.asarray(d), 1e-4, 1e4)
    bf = traverse.trace_bruteforce(t_(v0), t_(e1), t_(e2), t_(o), t_(d),
                                   1e-4, 1e4)
    hold_to_bar(bf, bf_ref, np.full(R, 1e4))
    np.testing.assert_array_equal(bf.prim.numpy(), np.asarray(bf_ref.prim))

    worlds = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    worlds[1, :3, :3] *= 0.5
    worlds[1, 3, :3] = (3.0, 1.0, -2.0)
    tlas = j_build_tlas([jb], jnp.asarray(worlds), mesh_ids=(0, 0))
    ref_s = j_traverse.trace_scene([jb], [(v0, e1, e2)], tlas,
                                   jnp.asarray(o), jnp.asarray(d), 1e-4, 1e4)
    t_tlas = TLAS(*(t_(x) for x in (tlas.worlds, tlas.inv_worlds,
                                    tlas.aabb_min, tlas.aabb_max)),
                  mesh_ids=(0, 0))
    got_s = traverse.trace_scene([tb], [(t_(v0), t_(e1), t_(e2))], t_tlas,
                                 t_(o), t_(d), 1e-4, 1e4)
    hold_to_bar(got_s, ref_s, np.full(R, 1e4))


def test_intersection_tests_match_reference():
    rng = np.random.default_rng(4)
    n = 2000
    o = rng.standard_normal((n, 3)).astype(np.float32) * 3
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[::7, 1] = 0.0                      # zero components: safe_inv_dir
    d[::11, 0] = -0.0
    v0 = rng.standard_normal((n, 3)).astype(np.float32)
    e1 = rng.standard_normal((n, 3)).astype(np.float32)
    e2 = rng.standard_normal((n, 3)).astype(np.float32)
    e2[::13] = e1[::13]                  # degenerate: det = 0 -> NaN, miss
    ref = j_intersect.moller_trumbore(o, d, v0, e1, e2, 0.0, 10.0)
    got = intersect.moller_trumbore(*(t_(x) for x in (o, d, v0, e1, e2)),
                                    0.0, 10.0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not got[3].numpy()[::13].any()
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
    inv_ref = j_intersect.safe_inv_dir(d)
    inv = intersect.safe_inv_dir(t_(d))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_ref))
    lo = rng.standard_normal((n, 3)).astype(np.float32)
    hi = lo + rng.random((n, 3)).astype(np.float32) * 2
    ref_b = j_intersect.ray_aabb(o, inv_ref, lo, hi, 0.0, 10.0)
    got_b = intersect.ray_aabb(t_(o), inv, t_(lo), t_(hi), 0.0, 10.0)
    np.testing.assert_array_equal(got_b[1].numpy(), np.asarray(ref_b[1]))
    np.testing.assert_array_equal(got_b[0].numpy(), np.asarray(ref_b[0]))


def test_calc_barycentrics_matches_reference():
    rng = np.random.default_rng(8)
    n = 3000
    p = rng.standard_normal((n, 3, 4)).astype(np.float32)
    p[..., 3] = 1.0 + rng.random((n, 3)).astype(np.float32) * 4
    ndc = (rng.random((n, 2)) * 2 - 1).astype(np.float32)
    bx_r, by_r = j_bary(jnp.asarray(p), jnp.asarray(ndc))
    bx, by = calc_barycentrics(t_(p), t_(ndc))
    # well-conditioned triangles only: the formula divides by the
    # projected area and the interpolated 1/w
    ok = (np.abs(np.asarray(bx_r)) < 10) & (np.abs(np.asarray(by_r)) < 10)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(bx.numpy()[ok], np.asarray(bx_r)[ok],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(by.numpy()[ok], np.asarray(by_r)[ok],
                               atol=1e-6, rtol=1e-5)


def test_formats_match_reference():
    rng = np.random.default_rng(12)
    x = np.concatenate([
        rng.standard_normal(4000) * 3,
        np.exp(rng.uniform(-20, 12, 4000)),        # denormal .. above max
        [0.0, -0.0, -1.0, 6.1e-5, 6.2e-5, 65024.0, 65025.0, 7e4, 1.0,
         0.5, np.inf, 1.0 + 2 ** -7, 1.0 + 3 * 2 ** -7]]).astype(np.float32)
    for bits in (2, 8, 10):
        np.testing.assert_allclose(
            formats.quantize_unorm(t_(x), bits).numpy(),
            np.asarray(j_formats.quantize_unorm(jnp.asarray(x), bits)),
            atol=1e-6)
    np.testing.assert_array_equal(
        formats.quantize_f16(t_(x)).numpy(),
        np.asarray(j_formats.quantize_f16(jnp.asarray(x))))
    rgb = x[:len(x) // 3 * 3].reshape(-1, 3)
    got = formats.quantize_r11g11b10(t_(rgb)).numpy()
    want = np.asarray(j_formats.quantize_r11g11b10(jnp.asarray(rgb)))
    # the small-float rounding is compared bit for bit
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for mantissa in (6, 5):            # float11 and float10 on every input
        np.testing.assert_array_equal(
            formats._quantize_small_float(t_(x), mantissa).numpy().view(
                np.int32),
            np.asarray(j_formats._quantize_small_float(
                jnp.asarray(x), mantissa)).view(np.int32))
