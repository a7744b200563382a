"""PyTorch port parity, the anchor cut and the bounce sort key.

``build_scene_wide``'s anchor cut (``anchor_boxes``, ``anchor_base``) must
equal the JAX package's at ``anchor_cut`` 8 and 32; ``anchor_ids_scene``
must equal the reference's where no instance's cut is padded, and, where
one is, on every ray whose reference id is a real box: the reference's
padded boxes (lo = 3e38, hi = -3e38) pass its slab test at t = 0 for every
ray, the port masks them (ROADMAP queue 3), and the test counts the rays
the pads took.  ``sort_rays_morton``'s order must equal the reference's at
``dir_bits`` 3 and 6, with and without the anchor, and a wave traced in
anchor order must give the same hits after un-permutation (the analog of
tests/test_scene_wide.py:166-)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.ops.scene_wide import anchor_bits as j_anchor_bits
from raytracedggx_tpu.ops.scene_wide import anchor_ids_scene as j_anchor_ids
from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.ops.traverse_pallas import sort_rays_morton as j_sort
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import Mesh as JMesh
from raytracedggx_tpu.trace.geometry import SceneGeometry as JGeometry
from raytracedggx_tpu.trace.geometry import upload_mesh as j_upload_mesh

from raytracedggx_tpu_torch.ops.ordering import sort_rays_morton
from raytracedggx_tpu_torch.ops.scene_wide import (anchor_bits,
                                                   anchor_ids_scene,
                                                   build_scene_wide,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.scripts.standin import model_mesh
from raytracedggx_tpu_torch.trace.geometry import upload_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = np.array([0.0, 2.0, 0.0, 1.0], np.float32)


def _pair(meshes, extra=()):
    """(JAX scene, port scene) over the same meshes (port Mesh objects)."""
    return (JScene(meshes=[JMesh(m.positions, m.normals, m.indices)
                           for m in meshes], materials=j_materials(),
                   pos_scale=POS, extra_instances=extra),
            Scene(meshes=list(meshes), materials=default_materials(),
                  pos_scale=POS, extra_instances=extra))


def _cubes():
    """3 instances of equal cuts: no padding."""
    return _pair([ground_cube(), ground_cube()], ((3.0, 1.0, 3.0, 0.5),))


def _padded():
    """The model under instance 0 and a cube, whose smaller cut is padded,
    as the LAST instance: a reference id taken by one of its pads is the
    total, never a real box's id."""
    return _pair([model_mesh(3), ground_cube()])


def _trees(scenes, cut, angle, leaf_size=8):
    js, ts = scenes
    jgeom = JGeometry(meshes=tuple(j_upload_mesh(m) for m in js.meshes),
                      blas=())
    ref = j_refit(j_build(jgeom, js.mesh_ids, leaf_size=leaf_size,
                          anchor_cut=cut), js.worlds(angle))
    sw = build_scene_wide(upload_scene(ts), ts.mesh_ids, leaf_size=leaf_size,
                          anchor_cut=cut)
    return ref, refit_scene_wide(sw, ts.worlds(angle))


def _rays(rng, n):
    """tests/test_scene_wide.py:_rand_rays."""
    o = rng.uniform(-6.0, 6.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 8.0, size=n)
    d = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("cut", [8, 32])
@pytest.mark.parametrize("scenes", [_cubes, _padded])
def test_anchor_cut_equals_reference(scenes, cut):
    ref, sw = _trees(scenes(), cut, 0.4)
    assert sw.anchor_base == ref.anchor_base
    assert sw.anchor_base[-1] >= 3
    np.testing.assert_array_equal(sw.anchor_boxes.numpy(),
                                  np.asarray(ref.anchor_boxes))
    assert anchor_bits(sw) == j_anchor_bits(ref)
    assert (1 << anchor_bits(sw)) >= sw.anchor_base[-1]
    # build_scene_wide(anchor_cut=0) builds none
    _, ts = scenes()
    sw0 = build_scene_wide(upload_scene(ts), ts.mesh_ids, leaf_size=8,
                           anchor_cut=0)
    assert sw0.anchor_boxes is None and anchor_bits(sw0) == 0


def test_anchor_ids_equal_reference_without_padding(rng):
    ref, sw = _trees(_cubes(), 8, 0.7)
    counts = np.diff(sw.anchor_base)
    assert (counts == counts[0]).all()             # no instance is padded
    o, d = _rays(rng, 512)
    want = np.asarray(j_anchor_ids(ref, jnp.asarray(o), jnp.asarray(d)))
    got = anchor_ids_scene(sw, torch.as_tensor(o), torch.as_tensor(d))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (want > 0).any()


def test_anchor_ids_on_padded_cuts(rng):
    """Rays from points on the model (inside its cut boxes, so the
    reference takes a real box at t = 0 there) and rays from outside; the
    ids agree on every ray whose reference id is a real box, and the rays
    the reference's pads took are counted: their port id is a real box's
    or 0."""
    scenes = _padded()
    ref, sw = _trees(scenes, 32, 0.3)
    total = sw.anchor_base[-1]
    counts = np.diff(sw.anchor_base)
    assert counts[-1] < counts[0] == sw.anchor_boxes.shape[1]   # padded
    tri = scenes[1].meshes[0].triangles()
    pick = rng.choice(len(tri), 256, replace=False)
    w = scenes[1].worlds(0.3)[0].numpy()
    p = tri[pick].mean(axis=1) @ w[:3, :3] + w[3, :3]   # on the model
    d_p = rng.normal(size=(256, 3)).astype(np.float32)
    d_p /= np.linalg.norm(d_p, axis=1, keepdims=True)
    o_r, d_r = _rays(rng, 256)
    o = np.concatenate([p.astype(np.float32), o_r])
    d = np.concatenate([d_p, d_r])
    want = np.asarray(j_anchor_ids(ref, jnp.asarray(o),
                                   jnp.asarray(d))).astype(np.int64)
    got = anchor_ids_scene(sw, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    real = want < total
    assert real[:256].all() and real.sum() >= 256
    np.testing.assert_array_equal(got[real], want[real])
    n_pad = int((~real).sum())
    assert n_pad > 0 and (want[~real] == total).all()
    assert (got < total).all()
    print(f"reference pads took {n_pad} of {len(want)} rays")


@pytest.mark.parametrize("anchor", [False, True])
@pytest.mark.parametrize("dir_bits", [3, 6])
def test_sort_order_equals_reference(rng, dir_bits, anchor):
    n = 2048
    o = rng.uniform(-8.0, 8.0, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = np.round(d[:64])                     # axis-aligned, ties
    live = rng.uniform(size=n) > 0.3
    lo, hi = np.full(3, -8.0, np.float32), np.full(3, 8.0, np.float32)
    ab = 6 if anchor else 0
    aid = rng.integers(0, 1 << ab, size=n) if anchor else None
    j_order, _ = j_sort(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                        jnp.asarray(hi), active=jnp.asarray(live),
                        dir_bits=dir_bits,
                        anchor=(None if aid is None
                                else jnp.asarray(aid, jnp.uint32)),
                        anchor_bits=ab)
    order, inv = sort_rays_morton(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lo),
        torch.as_tensor(hi), active=torch.as_tensor(live), dir_bits=dir_bits,
        anchor=None if aid is None else torch.as_tensor(aid),
        anchor_bits=ab)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert torch.equal(order[inv], torch.arange(n))
    with pytest.raises(ValueError):
        sort_rays_morton(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(lo), torch.as_tensor(hi),
                         dir_bits=4)


def test_anchor_ids_and_sort_key_parity(rng):
    """tests/test_scene_wide.py:166-: ids in range, the anchor key keeps
    dead rays last, and tracing in anchor order returns the same hits
    after un-permutation (the sort is a pure reordering)."""
    _, sw = _trees(_cubes(), 8, 0.7)
    total, ab = sw.anchor_base[-1], anchor_bits(sw)
    assert total >= 3 and (1 << ab) >= total
    o, d = (torch.as_tensor(x) for x in _rays(rng, 512))
    aid = anchor_ids_scene(sw, o, d)
    assert (aid < total).all() and (aid > 0).any()
    t_max = torch.where(torch.arange(512) % 3 == 0, -1.0, 1e4)
    lo, hi = torch.full((3,), -8.0), torch.full((3,), 8.0)
    for dir_bits in (3, 6):
        order, inv = sort_rays_morton(o, d, lo, hi, active=t_max > 0,
                                      dir_bits=dir_bits, anchor=aid,
                                      anchor_bits=ab)
        n_dead = int((t_max <= 0).sum())
        assert set(order[-n_dead:].tolist()) == set(
            torch.nonzero(t_max <= 0)[:, 0].tolist())
        ref, _ = trace_scene_wide_fused(sw, o, d, 0.0, t_max)
        got, _ = trace_scene_wide_fused(sw, o[order], d[order], 0.0,
                                        t_max[order])
        assert torch.equal(got.hit[inv], ref.hit)
        assert torch.equal(got.t[inv], ref.t)


def test_anchorbench_cpu_rehearsal():
    """The anchorbench port at a tiny resolution on the CPU: its three
    orders at leaf 8 and 64, one JSON line, t equal after
    un-permutation."""
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KB_RES="64x36", KB_SUBDIV="3")
    res = subprocess.run(
        [sys.executable, "-m", "raytracedggx_tpu_torch.scripts.anchorbench",
         "1", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = json.loads(res.stdout.splitlines()[-1])
    assert sorted(line["leaves"]) == ["64", "8"]
    for leaf in line["leaves"].values():
        assert leaf["anchors"] >= 3 and (1 << leaf["anchor_bits"]) >= \
            leaf["anchors"]
        assert list(leaf["orders"]) == ["base", "anchor", "anchor_only"]
        for row in leaf["orders"].values():
            assert row["parity"] == 0.0 and row["warp_node_mean"] > 0
