"""PyTorch port parity, the kernel lab's traversals (K6a, K6b) and their
helpers.

The port's plain ``trace_tiles_lab`` (a traversal in the kernels' visit
order) must match the JAX package's ``trace_tiles_lab`` (Pallas in
interpret mode), fed as scripts/kbench.py:200-208 feeds it: the fat
(``lean=False``) build's columns, ``lean_tris`` / ``sub_tris`` of them,
and three times the tree's stack for ``leaf_stack``
(tests/test_torch_lab_flags.py runs the ``sub`` and ``smem_nodes`` cases
on the same fixture).  The port's tree is
the reference's own, carried across from the ``lean=True`` build (the same
tree with an attrs table) by ``from_reference_arrays``.  The bar is that
of tests/test_scene_wide.py:56-63: exact hit mask, t at rtol 1e-4 / atol
1e-5, (inst, prim) on >= 99% of hits, u / v / normal at atol 1e-4 where
they agree, dead rays missing.  The scene is the 3-instance cube scene
of tests/test_torch_scene_wide.py at leaf size 16, 512 rays, every 4th
dead.

``fold`` and ``pre`` cannot run in interpret mode on the CPU (their
``pl.program_id`` inside the while loop has no CPU lowering), so they are
held against the port's own base variant here and against the plain
version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.bvh import build_lbvh as j_build_lbvh
from raytracedggx_tpu.ops.lab import fused_lab as jlab
from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.trace.geometry import SceneGeometry as JGeometry
from raytracedggx_tpu.trace.geometry import upload_mesh as j_upload_mesh

from raytracedggx_tpu_torch.ops.lab import fused_lab as lab
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   from_reference_arrays,
                                                   refit_scene_wide)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.trace.geometry import upload_scene

EXTRA, ANGLE, L, N_RAYS = ((3.0, 1.0, 3.0, 0.5),), 0.7, 16, 512


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


@pytest.fixture(scope="module")
def world():
    """(reference fat build, port structure, rays o, d, t_max)."""
    js, _ = _scenes(EXTRA)
    geom = JGeometry(meshes=tuple(j_upload_mesh(m) for m in js.meshes),
                     blas=())
    worlds = js.worlds(ANGLE)
    fat = j_refit(j_build(geom, js.mesh_ids, leaf_size=L, lean=False),
                  worlds)
    lean = j_refit(j_build(geom, js.mesh_ids, leaf_size=L), worlds)
    np.testing.assert_array_equal(np.asarray(fat.nodes),
                                  np.asarray(lean.nodes))
    sw = from_reference_arrays(
        *(np.asarray(x) for x in (lean.nodes, lean.tris, lean.inv_mats,
                                  lean.attrs)),
        leaf_size=L, stack=lean.stack, n_top=lean.n_top,
        top_children=lean.top_children)
    o, d = _rand_rays(np.random.default_rng(1234), N_RAYS)
    t_max = np.where(np.arange(N_RAYS) % 4 == 3, -1.0, 1e4).astype(np.float32)
    return fat, sw, o, d, t_max


def _port(sw, o, d, t_max, **kw):
    stack = sw.stack * (3 if kw.get("leaf_stack") else 1)
    boxes = lab.sub_tris(sw, kw["sub"]) if kw.get("sub") else None
    return lab.trace_tiles_lab(
        sw.nodes, sw.tris4, sw.inv_mats, torch.as_tensor(o),
        torch.as_tensor(d), 0.0, torch.as_tensor(t_max), leaf_size=L,
        stack=stack, attrs=sw.attrs, boxes=boxes, **kw)


def _hold(got, ref, t_max, slim=False, noinst=False):
    """The bar on (t, u, v, nrm, prim, inst) tuples."""
    g = [x.numpy() for x in got[:6]]
    r = [np.asarray(x) for x in ref[:6]]
    h = r[4] >= 0
    np.testing.assert_array_equal(g[4] >= 0, h)
    assert h.any() and not (g[4] >= 0)[t_max < 0].any()
    np.testing.assert_allclose(g[0][h], r[0][h], rtol=1e-4, atol=1e-5)
    same = ((g[4] == r[4]) & (g[5] == r[5]))[h]
    assert same.mean() > 0.99
    k = h & (g[4] == r[4]) & (g[5] == r[5])
    for a, b in ((g[1], r[1]), (g[2], r[2]), (g[3], r[3])):
        np.testing.assert_allclose(a[k], b[k], atol=1e-4)
    if slim:
        assert not g[1].any() and not g[2].any()
    if noinst:
        assert (g[5][h] == 0).all()
    return h


CASES = {
    "fat": dict(),
    "lean_recip": dict(lean=True, recip=True),
    "leaf_stack_lean_stats": dict(leaf_stack=True, lean=True, stats=True),
}


def check_against_reference(world, kw):
    """The port's plain trace_tiles_lab against the reference kernel in
    interpret mode on the same flags, fed as scripts/kbench.py feeds it."""
    fat, sw, o, d, t_max = world
    if kw.get("sub"):
        tris = jlab.sub_tris(fat, kw["sub"])
    else:
        tris = jlab.lean_tris(fat) if kw.get("lean") else fat.tris
    nodes = (jlab.nodes_flat_for_smem(fat) if kw.get("smem_nodes")
             else fat.nodes)
    stack = int(fat.stack) * (3 if kw.get("leaf_stack") else 1)
    ref = jlab.trace_tiles_lab(nodes, tris, fat.inv_mats, jnp.asarray(o),
                               jnp.asarray(d), 0.0, jnp.asarray(t_max),
                               leaf_size=L, interpret=True, stack=stack,
                               **kw)
    got = _port(sw, o, d, t_max, **kw)
    _hold(got, ref, t_max, kw.get("slim"), kw.get("noinst"))
    st = got[6]
    if kw.get("stats"):
        assert st.shape == (N_RAYS, 2) and st.dtype == torch.int32
        live = t_max >= 0
        assert not st[torch.as_tensor(~live)].any()      # dead: 0 / 0
        assert (st[torch.as_tensor(live), 0] >= 1).all()  # the root
        assert int(st[:, 1].sum()) > 0
    else:
        assert st is None


@pytest.mark.parametrize("case", list(CASES))
def test_lab_plain_matches_reference_kernel(world, case):
    check_against_reference(world, CASES[case])


def test_lean_and_sub_tris_equal_reference(world):
    fat, sw, _, _, _ = world
    S = sw.tris.shape[0]
    n_leaves = S // L
    lean = np.asarray(jlab.lean_tris(fat))             # (Lt, 10L, 128)
    cols = lean.transpose(0, 2, 1).reshape(-1, 10 * L)[:n_leaves]
    np.testing.assert_array_equal(lab.lean_tris(sw).numpy(),
                                  cols[:, :9 * L].reshape(S, 9))   # NaN pads
    np.testing.assert_array_equal(sw.attrs[:, 9].numpy(),
                                  cols[:, 9 * L:].reshape(S))
    for nq in (2, 4, 8):
        ref = np.asarray(jlab.sub_tris(fat, nq))      # (Lt, 9L + 6nq, 128)
        boxes = ref.transpose(0, 2, 1)[..., 9 * L:].reshape(-1, 6 * nq)
        got = lab.sub_tris(sw, nq)
        assert got.shape == (n_leaves, 6 * nq)
        np.testing.assert_array_equal(got.numpy(), boxes[:n_leaves])
        # 12 triangles in 16 slots: with 4+ chunks the last is all pads
        assert np.isnan(got.numpy()).any() == (nq >= 4)
    assert lab.nodes_flat_for_smem(sw) is sw.nodes


def test_pre_ray_state_matches_reference_formula(world):
    """fused_lab.py:796-803 in numpy: [o @ M3 + t | d @ M3 | safe_inv]."""
    _, sw, o, d, _ = world
    m = sw.inv_mats.numpy().reshape(-1, 4, 3)
    oo = np.einsum("rj,tja->tra", o, m[:, :3]) + m[:, None, 3]
    od = np.einsum("rj,tja->tra", d, m[:, :3])
    safe = np.where(np.abs(od) < 1e-20, np.where(od >= 0, 1e-20, -1e-20), od)
    want = np.concatenate([oo, od, 1.0 / safe], axis=-1)
    got = lab.pre_ray_state(sw.inv_mats, torch.as_tensor(o),
                            torch.as_tensor(d))
    assert got.shape == (m.shape[0], N_RAYS, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flags", [dict(fold=True),
                                   dict(pre=True, recip=True),
                                   dict(fold=True, pre=True, tile_s=16)])
def test_fold_and_pre_equal_base_variant(world, flags):
    _, sw, o, d, t_max = world
    base = _port(sw, o, d, t_max, lean=True, stats=True)
    got = _port(sw, o, d, t_max, lean=True, stats=True, **flags)
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b)


def test_hand_countable_counters(world):
    """A dead ray visits nothing; a ray that misses every top box visits
    the root only; a ray straight down onto the ground cube visits leaves."""
    _, sw, _, _, _ = world
    o = torch.tensor([[0.0, 5.0, 0.0], [0.0, 50.0, 0.0], [0.0, 9.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    t_max = torch.tensor([-1.0, 1e4, 1e4])
    for kw in (dict(), dict(leaf_stack=True), dict(npop=4, ordered=False)):
        out = _port(sw, o, d, t_max, stats=True, **kw)
        st = out[6].tolist()
        assert st[0] == [0, 0] and st[1] == [1, 0], (kw, st)
        assert st[2][0] >= 2 and st[2][1] >= 1, (kw, st)
        assert out[4][2] >= 0 and out[4][0] < 0 and out[4][1] < 0
        plain = lab.trace_lab_plain(sw.nodes, sw.tris, sw.attrs,
                                    sw.inv_mats, o, d, 0.0, t_max, L,
                                    sw.stack, **{k: v for k, v in kw.items()})
        assert plain[6][:, 2].max() < sw.stack       # no push was dropped


def test_lab_wrapper_raises_as_reference(world):
    _, sw, o, d, t_max = world
    bad = [dict(leaf_stack=True, pre=True),
           dict(sub=4),                                   # not lean
           dict(sub=4, lean=True, slim=True),
           dict(sub=4, lean=True, leaf_stack=True),
           dict(sub=3, lean=True),                        # 16 % 3
           dict(sub=4, lean=True, boxes=None),
           dict(npop=3), dict(tile_s=64)]
    for kw in bad:
        kw = dict(dict(boxes=lab.sub_tris(sw, 4)), **kw)
        with pytest.raises(ValueError):
            lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats,
                                torch.as_tensor(o[:8]),
                                torch.as_tensor(d[:8]), 0.0, 1e4, L,
                                attrs=sw.attrs, **kw)


def test_lbvh_builder_equals_reference():
    """build_scene_wide(builder="lbvh") on the per-mesh Karras trees gives
    the reference's arrays (leaf size 4, so the 12-triangle cubes split)."""
    js, ts = _scenes(EXTRA)
    meshes = tuple(j_upload_mesh(m) for m in js.meshes)
    blas = tuple(j_build_lbvh(m.positions, m.tri.reshape(-1))
                 for m in meshes)
    ref = j_build(JGeometry(meshes=meshes, blas=blas), js.mesh_ids,
                  leaf_size=4, builder="lbvh")
    got = build_scene_wide(upload_scene(ts), ts.mesh_ids, leaf_size=4,
                           builder="lbvh")
    sah = build_scene_wide(upload_scene(ts), ts.mesh_ids, leaf_size=4)
    N = got.num_nodes
    assert (N, got.stack) == (ref.num_nodes, ref.stack)
    rows = np.asarray(ref.nodes).transpose(0, 2, 1).reshape(-1, 36)[:N]
    np.testing.assert_array_equal(got.nodes.numpy()[:, 24:], rows[:, 24:])
    np.testing.assert_array_equal(got.nodes.numpy()[got.n_top:, :24],
                                  rows[got.n_top:, :24])
    slots = np.asarray(ref.tris).transpose(0, 2, 1).reshape(-1, 9)
    np.testing.assert_array_equal(got.tris.numpy(),
                                  slots[:got.tris.shape[0]])
    np.testing.assert_array_equal(got.attrs.numpy(),
                                  np.asarray(ref.attrs)[:, :10])
    assert not torch.equal(got.tris, sah.tris)       # another tree
    with pytest.raises(ValueError):
        build_scene_wide(upload_scene(ts), ts.mesh_ids, builder="bvh")


def _bound_scene(name, world):
    """A small test scene's port tree at leaf size 8 (the 3-instance cubes
    of the fixture at 16)."""
    from raytracedggx_tpu_torch.scripts.standin import (model_scene,
                                                        nested_scene)

    if name == "cubes":
        return world[1], L
    scene, angle = ((nested_scene(), 1.3) if name == "nested"
                    else (model_scene(3), 0.4))
    sw = build_scene_wide(upload_scene(scene), scene.mesh_ids, leaf_size=8)
    return refit_scene_wide(sw, scene.worlds(np.float32(angle))), 8


@pytest.mark.parametrize("scene", ["cubes", "nested", "model"])
@pytest.mark.parametrize("npop", [1, 2, 4])
def test_walk_stays_inside_stack_bound(world, scene, npop):
    """The plain walk's deepest stack (its third count), run with one
    entry more than ``stack_bound``, never exceeds the bound, so at the
    bound no push is dropped."""
    sw, leaf = _bound_scene(scene, world)
    bound = lab.stack_bound(sw.depth, npop)
    o, d = _rand_rays(np.random.default_rng(7 + npop), N_RAYS)
    t_max = torch.full((N_RAYS,), 1e4)
    out = lab.trace_lab_plain(sw.nodes, sw.tris, sw.attrs, sw.inv_mats,
                              torch.as_tensor(o), torch.as_tensor(d), 0.0,
                              t_max, leaf, bound + 1, npop)
    assert int((out[4] >= 0).sum()) > 0
    assert 1 < int(out[6][:, 2].max()) <= bound


def _full_tree(depth, leaves=False):
    """A full 4-ary tree of ``depth`` levels whose boxes all hold the
    origin, the bottom level's children empty (``leaves``: each a leaf of
    the one pad slot), and one pad slot."""
    n = sum(4 ** k for k in range(depth))
    inner = sum(4 ** k for k in range(depth - 1))
    nodes = torch.zeros((n, 36))
    nodes[:, :24] = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0] * 4)
    for i in range(inner):
        nodes[i, 24:28] = 2.0
        nodes[i, 28:32] = torch.arange(4 * i + 1, 4 * i + 5,
                                       dtype=torch.float32)
    if leaves:
        nodes[inner:, 24:28] = 1.0
    tris = torch.full((1, 9), float("nan"))
    return nodes, tris, torch.zeros((1, 10)), torch.eye(4)[:, :3].reshape(
        1, 12)


@pytest.mark.parametrize("npop,deepest", [(1, 10), (2, 16), (4, 28)])
def test_stack_bound_on_a_full_tree(npop, deepest):
    """Every box of a full 4-ary tree of depth 4 passes, so the walk
    pushes every internal child: its deepest stack is 3D - 2 = 10 at npop
    1 (the bound), 6D - 8 = 16 at npop 2 and 28 at npop 4, inside
    npop * (3D - 2)."""
    nodes, tris, attrs, inv = _full_tree(4)
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.3, -0.8, 0.5]])
    out = lab.trace_lab_plain(nodes, tris, attrs, inv, o, d, 0.0,
                              torch.tensor([1e4]), 1, 1000, npop)
    assert out[6][0].tolist() == [85, 0, deepest]      # every node visited
    assert deepest <= lab.stack_bound(4, npop)
    if npop == 1:
        assert deepest == lab.stack_bound(4, 1)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_ls_stack_bound_on_a_full_tree(depth):
    """K6b (leaves on the stack) on a full 4-ary tree whose bottom nodes
    hold 4 leaves each, every box passing: every node and leaf is visited
    and the deepest stack is the bound 6D - 2 of csrc/lab.cuh, what K6a's
    walk at npop 2 reaches on a full tree one level deeper."""
    nodes, tris, attrs, inv = _full_tree(depth, leaves=True)
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.3, -0.8, 0.5]])
    n_nodes = sum(4 ** k for k in range(depth))
    bound = lab.ls_stack_bound(depth)
    for ordered in (True, False):
        out = lab.trace_lab_plain(nodes, tris, attrs, inv, o, d, 0.0,
                                  torch.tensor([1e4]), 1, 1000,
                                  ordered=ordered, leaf_stack=True)
        assert out[6][0].tolist() == [n_nodes, 4 ** depth, bound]
        assert int(out[4][0]) == -1                    # pads only
    # the leaves as one more level of nodes: K6a's deepest stack at npop 2
    k6a = lab.trace_lab_plain(*_full_tree(depth + 1), o, d, 0.0,
                              torch.tensor([1e4]), 1, 1000, 2)
    assert int(k6a[6][0, 2]) == bound == 6 * depth - 2


@pytest.mark.parametrize("scene", ["cubes", "nested", "model"])
def test_ls_walk_stays_inside_stack_bound(world, scene):
    """K6b's plain walk, run with one entry more than ``ls_stack_bound``
    on a small scene, never exceeds the bound."""
    sw, leaf = _bound_scene(scene, world)
    bound = lab.ls_stack_bound(sw.depth)
    o, d = _rand_rays(np.random.default_rng(11), N_RAYS)
    t_max = torch.full((N_RAYS,), 1e4)
    out = lab.trace_lab_plain(sw.nodes, sw.tris, sw.attrs, sw.inv_mats,
                              torch.as_tensor(o), torch.as_tensor(d), 0.0,
                              t_max, leaf, bound + 1, leaf_stack=True)
    assert int((out[4] >= 0).sum()) > 0
    assert 1 < int(out[6][:, 2].max()) <= bound


def test_wrapper_raises_on_a_stack_beyond_shared_memory(world):
    """K6a's and K6b's stacks and staged rows must fit a block's 232,448
    bytes: 512 threads hold 113 entries each, not 114, and not 113 beside
    the staged rows; K6b's bound fits beside them."""
    _, sw, o, d, t_max = world
    assert sw.num_nodes * lab.ROW_BYTES > 232448 - 512 * 113 * 4

    def run(tile_s=32, **kw):
        return lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats,
                                   torch.as_tensor(o[:8]),
                                   torch.as_tensor(d[:8]), 0.0, 1e4, L,
                                   attrs=sw.attrs, tile_s=tile_s, **kw)

    for ls in (False, True):
        run(stack=113, leaf_stack=ls)
        for kw in (dict(stack=114), dict(stack=113, smem_nodes=True),
                   dict(stack=0), dict(stack=10 ** 6, tile_s=1)):
            with pytest.raises(ValueError, match="shared memory"):
                run(leaf_stack=ls, **kw)
    run(stack=lab.ls_stack_bound(sw.depth), leaf_stack=True, smem_nodes=True)
    with pytest.raises(ValueError, match="K6b"):
        run(stack=384, leaf_stack=True, smem_nodes=True)


def test_ptxas_reports_reads_each_kernel():
    """The build log's -Xptxas=-v lines give each kernel's registers,
    stack frame and spills, as chip_smoke.py phase 1 and the card tests
    read them for K6a's instances and K7."""
    from raytracedggx_tpu_torch.ops.cuda_lib import ptxas_reports

    log = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110lab_kernelILb1ELi2EEEvNS_7LabArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110lab_kernelILb1ELi2EEEvNS_7LabArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19ls_kernelILb0EEEvNS_7LabArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19ls_kernelILb0EEEvNS_7LabArgsE
    2048 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 560 bytes cmem[0]
"""
    rep = ptxas_reports(log)
    assert list(rep.values()) == [(72, 0, 0, 0), (64, 2048, 8, 4)]
    assert ["lab_kernel" in k for k in rep] == [True, False]
