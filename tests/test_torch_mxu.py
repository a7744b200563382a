"""PyTorch port parity, the linear-form leaf test (K7) and its coefficient
stream.

``mxu_stream`` must give the reference's coefficients bit for bit after
the layout change ((NL, 16, 128) lane blocks -> (n_leaves, 10, 4L); the
reference's rows 10-15 and lanes >= 4L are zero).  The port's plain
``trace_tiles_mxu``, fed the reference's own tree through
``from_reference_arrays``, must match the JAX kernel (Pallas in interpret
mode) at the bar of tests/test_scene_wide.py:56-63 on the 3-instance cube
scene at leaf size 8, 512 rays, every 4th dead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.ops.lab import fused_mxu as jmxu
from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.trace.geometry import SceneGeometry as JGeometry
from raytracedggx_tpu.trace.geometry import upload_mesh as j_upload_mesh

from raytracedggx_tpu_torch.ops.lab import fused_mxu as mxu
from raytracedggx_tpu_torch.ops.scene_wide import from_reference_arrays

N_RAYS = 512


def _ref_and_port(leaf_size):
    js = JScene(meshes=[j_ground_cube(), j_ground_cube()],
                materials=j_materials(),
                pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                extra_instances=((3.0, 1.0, 3.0, 0.5),))
    geom = JGeometry(meshes=tuple(j_upload_mesh(m) for m in js.meshes),
                     blas=())
    ref = j_refit(j_build(geom, js.mesh_ids, leaf_size=leaf_size),
                  js.worlds(0.7))
    sw = from_reference_arrays(
        *(np.asarray(x) for x in (ref.nodes, ref.tris, ref.inv_mats,
                                  ref.attrs)),
        leaf_size=leaf_size, stack=ref.stack, n_top=ref.n_top,
        top_children=ref.top_children)
    return ref, sw


@pytest.mark.parametrize("leaf_size", [8, 32])
def test_mxu_stream_equals_reference(leaf_size):
    ref, sw = _ref_and_port(leaf_size)
    L = leaf_size
    want = np.asarray(jmxu.mxu_stream(ref))            # (NL, 16, 128)
    got = mxu.mxu_stream(sw)
    n_leaves = sw.tris.shape[0] // L
    assert got.shape == (n_leaves, 10, 4 * L)
    np.testing.assert_array_equal(got.numpy(),
                                  want[:n_leaves, :10, :4 * L])   # NaN pads
    assert not want[:, 10:].any() and not want[:, :, 4 * L:].any()
    assert np.isnan(got.numpy()).any()


def test_mxu_plain_matches_reference_kernel():
    ref_sw, sw = _ref_and_port(8)
    rng = np.random.default_rng(1234)
    o = rng.uniform(-6.0, 6.0, size=(N_RAYS, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 8.0, size=N_RAYS)
    d = rng.uniform(-2.0, 2.0, size=(N_RAYS, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(np.arange(N_RAYS) % 4 == 3, -1.0, 1e4).astype(np.float32)
    ref = jmxu.trace_tiles_mxu(ref_sw.nodes, jmxu.mxu_stream(ref_sw),
                               ref_sw.inv_mats, jnp.asarray(o),
                               jnp.asarray(d), 0.0, jnp.asarray(t_max),
                               leaf_size=8, interpret=True,
                               stack=int(ref_sw.stack))
    got = mxu.trace_tiles_mxu(sw.nodes, mxu.mxu_stream(sw), sw.inv_mats,
                              sw.inst_slots, torch.as_tensor(o),
                              torch.as_tensor(d), 0.0,
                              torch.as_tensor(t_max), 8, sw.stack)
    g = [x.numpy() for x in got]
    r = [np.asarray(x) for x in ref]
    h = r[3] >= 0
    np.testing.assert_array_equal(g[3] >= 0, h)
    assert h.any() and not (g[3] >= 0)[t_max < 0].any()
    np.testing.assert_allclose(g[0][h], r[0][h], rtol=1e-4, atol=1e-5)
    same = ((g[3] == r[3]) & (g[4] == r[4]))[h]
    assert same.mean() > 0.99
    k = h & (g[3] == r[3]) & (g[4] == r[4])
    np.testing.assert_allclose(g[1][k], r[1][k], atol=1e-4)
    np.testing.assert_allclose(g[2][k], r[2][k], atol=1e-4)


def test_mxu_refuses_wide_leaves():
    """4L lanes must fit the 128-lane block, as in the reference."""
    _, sw = _ref_and_port(64)
    with pytest.raises(AssertionError):
        mxu.mxu_stream(sw)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        mxu.trace_tiles_mxu(sw.nodes, torch.zeros((1, 10, 256)),
                            sw.inv_mats, sw.inst_slots, o, o + 1.0, 0.0,
                            1e4, 64)


@pytest.mark.parametrize("leaf_size", [8, 32])
def test_mxu_records_equal_the_table(leaf_size):
    """The kernel's per-slot records hold the reference's table element
    for element: slot leaf * L + k, feature f, output g (det, u, v, t) is
    the table's [leaf, f, g * L + k]."""
    ref, sw = _ref_and_port(leaf_size)
    L = leaf_size
    n_leaves = sw.tris.shape[0] // L
    table = np.asarray(jmxu.mxu_stream(ref))[:n_leaves, :10, :4 * L]
    rec = mxu.mxu_records(torch.as_tensor(np.ascontiguousarray(table)))
    assert rec.shape == (n_leaves * L, 40) and rec.is_contiguous()
    leaf, k = np.divmod(np.arange(n_leaves * L), L)
    want = np.stack([table[leaf, f, g * L + k] for f in range(10)
                     for g in range(4)], axis=1)
    np.testing.assert_array_equal(rec.numpy(), want)          # NaN pads


def test_mxu_records_built_once_per_table():
    _, sw = _ref_and_port(8)
    coef = mxu.mxu_stream(sw)
    rec = mxu._records_of(coef)
    assert mxu._records_of(coef) is rec
    coef[0, 9, 0] += 1.0                       # written to: built again
    again = mxu._records_of(coef)
    assert again is not rec and float(again[0, 36]) == float(coef[0, 9, 0])
    key = id(coef)
    del coef
    assert key not in mxu._RECORDS


def test_mxu_wrapper_raises_on_a_stack_beyond_shared_memory():
    """K7's stacks must fit a block's 232,448 bytes: 512 threads hold 113
    entries each, not 114."""
    _, sw = _ref_and_port(8)
    o = torch.zeros((4, 3))
    coef = mxu.mxu_stream(sw)

    def run(stack, tile_s=32):
        return mxu.trace_tiles_mxu(sw.nodes, coef, sw.inv_mats,
                                   sw.inst_slots, o, o + 1.0, 0.0, 1e4, 8,
                                   stack, tile_s)

    run(113)
    for stack, tile_s in ((114, 32), (0, 8), (10 ** 6, 1)):
        with pytest.raises(ValueError, match="shared memory"):
            run(stack, tile_s)
