"""PyTorch port parity, instanced scene BVH and traversal (K1).

The port's build and refit must equal the JAX package's arrays after the
layout change ((Nt, 36, 128) -> (N, 36) node rows, (Lt, 9L, 128) -> (S, 9)
stream slots).  K1's plain version, fed the reference's own BVH through
``from_reference_arrays``, must match the JAX traversal kernel (Pallas in
interpret mode) at the bar of tests/test_scene_wide.py: exact hit mask, t
at rtol 1e-4 / atol 1e-5, (inst, prim) on >= 99% of hits, and rays with
t_max = -1 missing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.ops.scene_wide import trace_scene_wide_fused as j_trace
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.trace.geometry import SceneGeometry as JGeometry
from raytracedggx_tpu.trace.geometry import upload_mesh as j_upload_mesh

from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   from_reference_arrays,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.trace.geometry import upload_scene

CASES = [
    ((), 0.0),
    (((3.0, 1.0, 3.0, 0.5),), 0.7),                        # 3 instances
    (tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
           for i in range(7)), 1.3),                       # 9: nested top
]


def _scenes(extra):
    kw = dict(pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
              extra_instances=tuple(extra))
    return (JScene(meshes=[j_ground_cube(), j_ground_cube()],
                   materials=j_materials(), **kw),
            Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), **kw))


def _rand_rays(rng, n):
    """tests/test_scene_wide.py:_rand_rays."""
    o = rng.uniform(-6.0, 6.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 8.0, size=n)
    tgt = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _ref_geom(js):
    """The reference's per-mesh arrays; its SAH scene build reads no
    LBVH, so none is built (that jit compile costs tens of seconds)."""
    return JGeometry(meshes=tuple(j_upload_mesh(m) for m in js.meshes),
                     blas=())


def _ref_bvh(js, angle, leaf_size=16):
    sw = j_build(_ref_geom(js), js.mesh_ids, leaf_size=leaf_size)
    return j_refit(sw, js.worlds(angle))


@pytest.mark.parametrize("extra,angle", CASES[1:])
def test_build_and_refit_equal_reference(extra, angle):
    js, ts = _scenes(extra)
    ref = _ref_bvh(js, angle)
    got = build_scene_wide(upload_scene(ts), ts.mesh_ids, leaf_size=16)
    got = refit_scene_wide(got, ts.worlds(angle))

    N, L = got.num_nodes, got.leaf_size
    assert (N, got.n_top, got.stack, L) == (ref.num_nodes, ref.n_top,
                                           ref.stack, ref.leaf_size)
    assert got.top_children == ref.top_children
    rows = np.asarray(ref.nodes).transpose(0, 2, 1).reshape(-1, 36)
    nodes = got.nodes.numpy()
    # topology, object-space boxes and streams are identical host builds
    np.testing.assert_array_equal(nodes[:, 24:], rows[:N, 24:])
    np.testing.assert_array_equal(nodes[got.n_top:, :24],
                                  rows[got.n_top:N, :24])
    slots = np.asarray(ref.tris).transpose(0, 2, 1).reshape(-1, 9)
    S = got.tris.shape[0]
    np.testing.assert_array_equal(got.tris.numpy(), slots[:S])   # NaN pads
    np.testing.assert_array_equal(got.attrs.numpy(),
                                  np.asarray(ref.attrs)[:, :10])
    # per-frame refit: instance world boxes and inverse worlds (f32 math
    # in another order: last-bit differences only)
    np.testing.assert_allclose(nodes[:got.n_top, :24],
                               rows[:got.n_top, :24], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.inv_mats.numpy(),
                               np.asarray(ref.inv_mats), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.root_corners.numpy(),
                               np.asarray(ref.root_corners))


@pytest.mark.parametrize("extra,angle", CASES)
def test_k1_plain_matches_reference_kernel(rng, extra, angle):
    js, _ = _scenes(extra)
    ref_sw = _ref_bvh(js, angle)
    sw = from_reference_arrays(
        *(np.asarray(x) for x in (ref_sw.nodes, ref_sw.tris,
                                  ref_sw.inv_mats, ref_sw.attrs)),
        leaf_size=ref_sw.leaf_size, stack=ref_sw.stack, n_top=ref_sw.n_top,
        top_children=ref_sw.top_children)

    o, d = _rand_rays(rng, 512)
    t_max = np.where(np.arange(512) % 4 == 3, -1.0, 1e4).astype(np.float32)
    ref, ref_n = j_trace(ref_sw, jnp.asarray(o), jnp.asarray(d), 0.0,
                         jnp.asarray(t_max), interpret=True)
    got, got_n = trace_scene_wide_fused(sw, torch.as_tensor(o),
                                        torch.as_tensor(d), 0.0,
                                        torch.as_tensor(t_max))

    h = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    assert h.any() and not got.hit.numpy()[t_max < 0].any()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                               rtol=1e-4, atol=1e-5)
    same = ((got.inst.numpy() == np.asarray(ref.inst))
            & (got.prim.numpy() == np.asarray(ref.prim)))[h]
    assert same.mean() > 0.99
    k = h & (got.prim.numpy() == np.asarray(ref.prim))
    for a, b in ((got.u, ref.u), (got.v, ref.v), (got_n, ref_n)):
        np.testing.assert_allclose(a.numpy()[k], np.asarray(b)[k], atol=1e-4)


def _standin(subdiv):
    from raytracedggx_tpu_torch.scripts.standin import model_scene

    return model_scene(subdiv)


def _nested():
    return _scenes(CASES[2][0])[1]


@pytest.mark.parametrize("leaf_size", [8, 64])
def test_float4_rows_equal_slot_stream(leaf_size):
    """K1's (S, 12) rows are the (S, 9) stream with each vector padded by
    a 0: the same slots, NaN pads kept."""
    for scene in (_nested(), _standin(3)):
        sw = build_scene_wide(upload_scene(scene), scene.mesh_ids,
                              leaf_size=leaf_size)
        rows = sw.tris4.numpy().reshape(-1, 3, 4)
        assert sw.tris4.shape == (sw.tris.shape[0], 12)
        np.testing.assert_array_equal(rows[..., :3].reshape(-1, 9),
                                      sw.tris.numpy())
        assert not rows[..., 3].any()
        pad = np.isnan(sw.tris.numpy()[:, 0])
        assert pad.any() and np.isnan(rows[pad, 0, 0]).all()


def _aimed_rays(rng, n, center, spread):
    """Rays from around a scene toward random points near ``center``."""
    o = rng.uniform(-6.0, 6.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(1.0, 8.0, size=n)
    tgt = center + rng.uniform(-spread, spread, size=(n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("scene", ["standin", "nested"])
def test_k1_stack_bounds_the_walk(rng, scene, leaf_size):
    """k1_stack = 3 * depth + 1 is at least the deepest stack of a walk in
    the kernels' near-first order (trace_lab_plain, one pop per step) over
    rays aimed at the scene, and fits the kernel's 64 for the stand-in."""
    from raytracedggx_tpu_torch.ops.lab.fused_lab import trace_lab_plain

    if scene == "standin":
        sc, center, spread = _standin(6), np.array([0.0, 1.0, 0.0]), 1.3
    else:
        sc, center, spread = _nested(), np.array([0.0, 1.0, 1.0]), 6.0
    sw = build_scene_wide(upload_scene(sc), sc.mesh_ids, leaf_size=leaf_size)
    sw = refit_scene_wide(sw, sc.worlds(0.7))
    o, d = _aimed_rays(rng, 384, center, spread)
    t_max = torch.full((384,), 1e4)
    out = trace_lab_plain(sw.nodes, sw.tris, sw.attrs, sw.inv_mats, o, d,
                          0.0, t_max, leaf_size, stack=128, npop=1,
                          ordered=True, lean=True)
    deepest = int(out[6][:, 2].max())
    assert int((out[4] >= 0).sum()) > 100           # the walks reach leaves
    assert 2 <= deepest <= sw.k1_stack
    if scene == "standin":
        assert sw.k1_stack <= 64
