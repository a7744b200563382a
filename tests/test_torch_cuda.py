"""The port's CUDA kernels (K1-K7, XF, TS, BS) against their plain torch
versions on the card.  Every test here needs an NVIDIA GPU with nvcc and skips
without one; this file imports neither jax nor the JAX package, so on a
GPU machine without JAX it runs on its own:

    python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raytracedggx_tpu_torch.bvh import build_lbvh, build_tlas
from raytracedggx_tpu_torch.denoise import tm
from raytracedggx_tpu_torch.ops import (flatten, fused, spatial_cuda,
                                        traverse_cuda, wide, xform_cuda)
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   refit_scene_wide)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.trace.geometry import upload_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc on sm_90a)")
    return torch.device("cuda", 0)


def _rand_rays(rng, n, device):
    o = rng.uniform(-6.0, 6.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 8.0, size=n)
    d = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def _k1(sw, o, d, t_max, t_min=0.0, stats=None):
    return fused.trace_tiles_instanced(sw.nodes, sw.tris4, sw.inv_mats,
                                       sw.inst_slots, o, d, t_min, t_max,
                                       sw.leaf_size, sw.k1_stack, stats)


@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("n_extra", [0, 7])
def test_k1_kernel_matches_plain(cuda, n_extra, leaf_size):
    """The cube scene with 2 or 9 instances (nested top tree: rays enter
    several instances), at the renderer's leaf size and at 64."""
    rng = np.random.default_rng(7)
    extra = tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
                  for i in range(n_extra))
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                  extra_instances=extra)
    sw = build_scene_wide(upload_scene(scene, cuda), scene.mesh_ids,
                          leaf_size=leaf_size, device=cuda)
    sw = refit_scene_wide(sw, scene.worlds(1.3).to(cuda))
    o, d = _rand_rays(rng, 4096, cuda)
    t_max = torch.where(torch.arange(4096, device=cuda) % 3 == 0, -1.0, 1e4)
    n0 = fused.trace_tiles_instanced.launches
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = _k1(sw, o, d, t_max, stats=stats)
    ref = fused.trace_instanced_plain(sw.tris, sw.inv_mats, sw.inst_slots,
                                      o, d, 0.0, t_max)
    torch.cuda.synchronize()
    assert fused.trace_tiles_instanced.launches == n0 + 1
    _hold(got[0], got[3], ref[0], ref[3], t_max, got[4], ref[4])
    assert int(stats[0]) > 0 and int(stats[1]) > 0
    if n_extra:
        assert len(set(got[4][got[3] >= 0].tolist())) > 2


@pytest.mark.parametrize("leaf_size", [8, 64])
def test_k1_kernel_matches_plain_on_model(cuda, leaf_size):
    """The 5,120-triangle stand-in model: deeper trees, full leaves."""
    sw = _model_bvh(cuda, leaf_size)
    o, d, t_max = _model_rays(cuda)
    got = _k1(sw, o, d, t_max, 1e-4)
    ref = fused.trace_instanced_plain(sw.tris, sw.inv_mats, sw.inst_slots,
                                      o, d, 1e-4, t_max)
    torch.cuda.synchronize()
    _hold(got[0], got[3], ref[0], ref[3], t_max, got[4], ref[4])


def test_k1_wrapper_refuses_deep_or_misaligned_trees(cuda):
    """A tree whose stack bound exceeds the kernel's compiled 64, and
    slot rows that are not 16-byte aligned, raise instead of launching."""
    sw = _model_bvh(cuda, 8)
    o, d, t_max = _model_rays(cuda, 64)
    assert sw.k1_stack <= 64
    n0 = fused.trace_tiles_instanced.launches
    with pytest.raises(ValueError):
        _k1(sw._replace(k1_stack=65), o, d, t_max)
    shifted = torch.empty(sw.tris4.numel() + 1, device=cuda)[1:]
    shifted.copy_(sw.tris4.reshape(-1))
    with pytest.raises(ValueError):
        _k1(sw._replace(tris4=shifted.reshape(-1, 12)), o, d, t_max)
    assert fused.trace_tiles_instanced.launches == n0


@pytest.mark.parametrize("hw", [(45, 70), (55, 97), (33, 61), (720, 1280)])
@pytest.mark.parametrize("axis", [1, 0])
def test_spatial_kernels_match_plain(cuda, axis, hw):
    """Both axes at sizes that are no multiple of the kernels' tiles or of
    K3's 4 outputs per thread, and at the frame's; roughness in
    [0, 1] puts most pixels' Gaussian radius at its clip 0.05 * height.
    At 1280x720 some pixels have every tap's weight below 1e-30 but one,
    whose roughness weight is 0: the kernel must round that weight as the
    plain pass does."""
    rng = np.random.default_rng(11)
    h, w = hw
    normal = rng.random((h, w, 4)).astype(np.float32)
    n = normal[..., :3] * 2 - 1
    normal[..., :3] = n / np.linalg.norm(n, axis=-1, keepdims=True) * 0.5 \
        + 0.5
    normal[..., 3] = rng.random((h, w)) > 0.2

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=cuda)

    nrm = dev(normal)
    rough = dev(rng.random((h, w)))
    metal = dev(rng.choice([0.0, 0.5, 1.0], size=(h, w)))
    depth = dev(0.3 + 0.6 * rng.random((h, w)))
    src = tm(dev(rng.random((h, w, 3)) * 3)).contiguous()
    pairs = [
        (spatial_cuda.reflection_pass(src, nrm, rough, depth, w, h, axis),
         spatial_cuda.reflection_pass_plain(src, nrm, rough, depth, w, h,
                                            axis))]
    pairs.append(
        (spatial_cuda.diffuse_pass(src, nrm, metal, depth, axis),
         spatial_cuda.diffuse_pass_plain(src, nrm, metal, depth, axis)))
    for got, ref in pairs:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)


def test_wrappers_refuse_bad_inputs(cuda):
    """A CUDA tensor never falls back to the plain version: bad inputs
    raise instead."""
    x = torch.zeros((8, 8, 3), device=cuda)
    n = torch.zeros((8, 8, 4), device=cuda)
    a = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        spatial_cuda.reflection_pass(x.double(), n, a, a, 8, 8, 1)
    with pytest.raises(ValueError):
        spatial_cuda.diffuse_pass(x, n, a.t(), a, 0)


PER_MESH = {"K4": (flatten.flatten_bvh, traverse_cuda.trace_tiles_flat,
                   traverse_cuda.trace_scene_flat, "pallas", "flat"),
            "K5": (wide.flatten_bvh4, wide.trace_tiles4, wide.trace_scene4,
                   "pallas4", "wide")}


def _hold(got_t, got_id, ref_t, ref_id, t_max, got_inst=None, ref_inst=None):
    hit = ref_id >= 0
    assert torch.equal(got_id >= 0, hit) and bool(hit.any())
    assert not bool((got_id[t_max < 0] >= 0).any())
    torch.testing.assert_close(got_t[hit], ref_t[hit], rtol=1e-4, atol=1e-5)
    same = got_id == ref_id
    if got_inst is not None:
        same = same & (got_inst == ref_inst)
    assert float(same[hit].float().mean()) >= 0.99


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("leaf_size", [1, 8])
def test_per_mesh_kernels_match_plain(cuda, kernel, leaf_size):
    """One mesh of random triangles, rays moved to its object space by an
    inverse world inside the kernel, every third ray dead."""
    flatten_fn, wrapper, _, _, _ = PER_MESH[kernel]
    rng = np.random.default_rng(5)
    n = 3000
    base = (rng.random((n, 1, 3)) - 0.5) * 8
    pos = (base + (rng.random((n, 3, 3)) - 0.5)).reshape(-1, 3)
    pos = torch.as_tensor(pos.astype(np.float32), device=cuda)
    tri = pos.reshape(-1, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    tree = flatten_fn(build_lbvh(pos, torch.arange(3 * n, device=cuda)),
                      v0, e1, e2, leaf_size=leaf_size)
    world = torch.eye(4)
    world[:3, :3] = torch.tensor([[0.8, 0.0, -0.6], [0.0, 1.3, 0.0],
                                  [0.6, 0.0, 0.8]])
    world[3, :3] = torch.tensor([1.0, -2.0, 0.5])
    inv = traverse_cuda.inv_rows(torch.linalg.inv(world)[None])[0].to(cuda)
    o, d = _rand_rays(rng, 4096, cuda)
    t_max = torch.where(torch.arange(4096, device=cuda) % 3 == 0, -1.0, 1e4)
    n0 = wrapper.launches
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = wrapper(tree, o, d, 1e-4, t_max, inv, stats)
    ref = traverse_cuda.trace_stream_plain(tree.tris, o, d, 1e-4, t_max, inv)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    _hold(got[0], got[3], ref[0], ref[3], t_max)
    assert int(stats[0]) > 0 and int(stats[1]) > 0


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_per_instance_loops_match_plain(cuda, kernel):
    """The 9-instance nested scene through trace_scene_flat / trace_scene4:
    kernel against the same loop over the plain version."""
    _, _, scene_fn, traversal, key = PER_MESH[kernel]
    extra = tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
                  for i in range(7))
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                  extra_instances=extra)
    geom = upload_scene(scene, cuda, traversal=traversal, leaf_size=8)
    tlas = build_tlas(geom.bounds, scene.worlds(1.3).to(cuda),
                      scene.mesh_ids)
    o, d = _rand_rays(np.random.default_rng(9), 4096, cuda)
    t_max = torch.where(torch.arange(4096, device=cuda) % 2 == 0, 1e4, -1.0)
    got = scene_fn(getattr(geom, key), tlas, o, d, 0.0, t_max, impl="cuda")
    ref = scene_fn(getattr(geom, key), tlas, o, d, 0.0, t_max, impl="xla")
    torch.cuda.synchronize()
    _hold(got.t, got.prim, ref.t, ref.prim, t_max, got.inst, ref.inst)
    assert len(set(got.inst[got.hit].tolist())) > 2


def _comb_mesh():
    """32 triangles whose Morton codes are 0, 2^b for b = 0..29 and all
    ones, in a 1024-unit cube: the radix tree peels one code per level,
    so the 4-wide tree is deep."""
    cents = [(0.5, 0.5, 0.5)]
    for b in range(30):
        q = [0.5, 0.5, 0.5]
        q[2 - b % 3] = 2 ** (b // 3) + 0.5
        cents.append(tuple(q))
    cents.append((1023.5, 1023.5, 1023.5))
    c = np.array(cents, np.float32)
    off = np.array([[-0.2, -0.1, 0.0], [0.2, -0.1, 0.1], [0.0, 0.2, -0.1]],
                   np.float32)
    tri = c[:, None, :] + off[None]
    tri[0, 0] = (0.0, 0.0, 0.0)
    tri[-1, 1] = (1024.0, 1024.0, 1024.0)
    return tri.reshape(-1, 3), c


def test_k5_deep_tree_matches_plain(cuda):
    """A tree whose stack bound lies between 29 and 64, so K5's
    shared-memory stack is sized above what the model's trees need; rays
    aimed at the triangles walk its deepest paths."""
    pos, cents = _comb_mesh()
    pos = torch.as_tensor(pos, device=cuda)
    tri = pos.reshape(-1, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    w4 = wide.flatten_bvh4(build_lbvh(pos, torch.arange(pos.shape[0],
                                                        device=cuda)),
                           v0, e1, e2, leaf_size=1)
    assert 29 < w4.stack <= 64
    rng = np.random.default_rng(13)
    n = 4096
    o = rng.uniform(-50.0, 1100.0, size=(n, 3)).astype(np.float32)
    aim = cents[rng.integers(0, len(cents), n)] + rng.normal(
        0.0, 0.05, size=(n, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    t_max = torch.where(torch.arange(n, device=cuda) % 3 == 0, -1.0, 1e5)
    n0 = wide.trace_tiles4.launches
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = wide.trace_tiles4(w4, o, d, 0.0, t_max, None, stats)
    ref = traverse_cuda.trace_stream_plain(w4.tris, o, d, 0.0, t_max)
    torch.cuda.synchronize()
    assert wide.trace_tiles4.launches == n0 + 1
    _hold(got[0], got[3], ref[0], ref[3], t_max)
    assert float((ref[3] >= 0).float().mean()) > 0.3
    assert int(stats[0]) > 0 and int(stats[1]) > 0


@pytest.mark.parametrize("leaf_size", [1, 8])
def test_k4_ties_go_to_the_later_stream_position(cuda, leaf_size):
    """Every triangle twice: the two copies tie at exactly the same t, and
    K4 returns the later stream position of the pair on every hit, as the
    TPU kernel's DFS walk with t <= best_t does (and the plain version,
    which keeps the last of equal t)."""
    rng = np.random.default_rng(17)
    n = 1500
    base = (rng.random((n, 1, 3)) - 0.5) * 8
    tri = (base + (rng.random((n, 3, 3)) - 0.5)).astype(np.float32)
    tri = np.concatenate([tri, tri])
    pos = torch.as_tensor(tri.reshape(-1, 3), device=cuda)
    t3 = pos.reshape(-1, 3, 3)
    flat = flatten.flatten_bvh(
        build_lbvh(pos, torch.arange(pos.shape[0], device=cuda)), t3[:, 0],
        t3[:, 1] - t3[:, 0], t3[:, 2] - t3[:, 0], leaf_size=leaf_size)
    where = torch.argsort(flat.tri_perm)        # triangle id -> position
    later = torch.maximum(where[flat.tri_perm % n],
                          where[flat.tri_perm % n + n])
    cents = torch.as_tensor(tri[:n].mean(axis=1), device=cuda)
    R = 4096
    o = torch.as_tensor(rng.uniform(-8.0, 8.0, size=(R, 3)).astype(np.float32),
                        device=cuda)
    d = cents[torch.as_tensor(rng.integers(0, n, R), device=cuda)] - o
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    t_max = torch.where(torch.arange(R, device=cuda) % 5 == 0, -1.0, 1e4)
    got = traverse_cuda.trace_tiles_flat(flat, o, d, 1e-4, t_max)
    ref = traverse_cuda.trace_stream_plain(flat.tris, o, d, 1e-4, t_max)
    torch.cuda.synchronize()
    _hold(got[0], got[3], ref[0], ref[3], t_max)
    hit = got[3] >= 0
    assert float(hit.float().mean()) > 0.5
    pos_hit = got[3][hit].long()
    assert torch.equal(pos_hit, later[pos_hit])


def test_k4_deep_tree_matches_plain(cuda):
    """A tree of depth between 29 and 64 (the model's is 20 at leaf 8), so
    K4's shared-memory stack is sized above what the model needs; rays
    aimed at the triangles walk its deepest paths."""
    pos, cents = _comb_mesh()
    pos = torch.as_tensor(pos, device=cuda)
    tri = pos.reshape(-1, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    flat = flatten.flatten_bvh(build_lbvh(pos, torch.arange(pos.shape[0],
                                                            device=cuda)),
                               v0, e1, e2, leaf_size=1)
    assert 29 < flat.stack <= 64
    rng = np.random.default_rng(19)
    n = 4096
    o = rng.uniform(-50.0, 1100.0, size=(n, 3)).astype(np.float32)
    aim = cents[rng.integers(0, len(cents), n)] + rng.normal(
        0.0, 0.05, size=(n, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    t_max = torch.where(torch.arange(n, device=cuda) % 3 == 0, -1.0, 1e5)
    n0 = traverse_cuda.trace_tiles_flat.launches
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = traverse_cuda.trace_tiles_flat(flat, o, d, 0.0, t_max, None, stats)
    ref = traverse_cuda.trace_stream_plain(flat.tris, o, d, 0.0, t_max)
    torch.cuda.synchronize()
    assert traverse_cuda.trace_tiles_flat.launches == n0 + 1
    _hold(got[0], got[3], ref[0], ref[3], t_max)
    assert float((ref[3] >= 0).float().mean()) > 0.3
    assert int(stats[0]) > 0 and int(stats[1]) > 0


def test_per_mesh_wrappers_refuse_bad_inputs(cuda):
    """Non-contiguous rays, K4 and K5 trees deeper than the kernels'
    stacks and float4 rows that are not 16-byte aligned raise instead of
    falling back."""
    pos = torch.rand((300, 3), device=cuda)
    tri = pos.reshape(-1, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    bvh = build_lbvh(pos, torch.arange(300, device=cuda))
    flat = flatten.flatten_bvh(bvh, v0, e1, e2)
    w4 = wide.flatten_bvh4(bvh, v0, e1, e2)
    rays = torch.rand((64, 6), device=cuda)
    o, d = rays[:, :3], rays[:, 3:]
    n0 = (traverse_cuda.trace_tiles_flat.launches, wide.trace_tiles4.launches)
    with pytest.raises(ValueError):
        traverse_cuda.trace_tiles_flat(flat, o, d, 0.0, 1e4)
    o, d = o.contiguous(), d.contiguous()
    with pytest.raises(ValueError):                 # deeper than 64
        traverse_cuda.trace_tiles_flat(flat._replace(stack=65), o, d, 0.0,
                                       1e4)
    with pytest.raises(ValueError):
        wide.trace_tiles4(w4._replace(stack=10 ** 6), o, d, 0.0, 1e4)

    def shifted(rows):                              # not 16-byte aligned
        t = torch.empty(rows.numel() + 1, device=cuda)[1:]
        t.copy_(rows.reshape(-1))
        return t.reshape(rows.shape)

    for bad in (flat._replace(pairs=shifted(flat.pairs)),
                flat._replace(tris4=shifted(flat.tris4))):
        with pytest.raises(ValueError):
            traverse_cuda.trace_tiles_flat(bad, o, d, 0.0, 1e4)
    with pytest.raises(ValueError):
        wide.trace_tiles4(w4._replace(tris4=shifted(w4.tris4)), o, d, 0.0,
                          1e4)
    assert (traverse_cuda.trace_tiles_flat.launches,
            wide.trace_tiles4.launches) == n0


LAB_CASES = {
    "fat": dict(),
    "lean_recip": dict(lean=True, recip=True),
    "fold_stats": dict(lean=True, fold=True, stats=True),
    "pre_recip_stats": dict(lean=True, pre=True, recip=True, stats=True),
    "prefold_t4": dict(lean=True, pre=True, fold=True, tile_s=4, stats=True),
    "smem_npop4_slim_noinst_unordered": dict(smem_nodes=True, npop=4,
                                             slim=True, noinst=True,
                                             ordered=False, stats=True),
    "sub4_recip_t16": dict(lean=True, sub=4, recip=True, tile_s=16,
                           stats=True),
    "npop1_t2": dict(npop=1, tile_s=2, stats=True),
    "K6b_lean": dict(leaf_stack=True, lean=True, stats=True),
    "K6b_fat_smem_t32": dict(leaf_stack=True, smem_nodes=True, tile_s=32,
                             stats=True),
    "K6b_fat": dict(leaf_stack=True, stats=True),
    "K6b_lean_smem_unordered_t2": dict(leaf_stack=True, lean=True,
                                       smem_nodes=True, ordered=False,
                                       tile_s=2, stats=True),
}


def _model_bvh(device, leaf_size):
    from raytracedggx_tpu_torch.scripts.standin import model_scene

    scene = model_scene(4)                       # 5,120-triangle model
    sw = build_scene_wide(upload_scene(scene, device), scene.mesh_ids,
                          leaf_size=leaf_size, device=device)
    return refit_scene_wide(sw, scene.worlds(0.4).to(device))


def _model_rays(device, n=4096):
    rng = np.random.default_rng(3)
    o = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(2.0, 6.0, size=n)
    d = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32) - o
    d[:, 1] += 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(np.arange(n) % 3 == 0, -1.0, 1e4).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (o, d, t_max))


@pytest.mark.parametrize("case", list(LAB_CASES))
def test_lab_kernels_match_plain(cuda, case):
    """K6a / K6b against trace_lab_plain on the stand-in model scene:
    outputs at the traversal bar, per-ray visit counts equal on >= 99% of
    rays (fmad rounding may flip a box test at its edge)."""
    from raytracedggx_tpu_torch.ops.lab import fused_lab as lab

    kw = LAB_CASES[case]
    sw = _model_bvh(cuda, 16)
    o, d, t_max = _model_rays(cuda)
    stack = (lab.ls_stack_bound(sw.depth) if kw.get("leaf_stack")
             else lab.stack_bound(sw.depth, kw.get("npop", 2)))
    boxes = lab.sub_tris(sw, kw["sub"]) if kw.get("sub") else None
    counter = lab.ls_kernel if kw.get("leaf_stack") else lab.lab_kernel
    n0 = counter.launches
    totals = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats, o, d, 0.0,
                              t_max, 16, stack=stack, attrs=sw.attrs,
                              boxes=boxes, totals=totals, **kw)
    plain_kw = {k: v for k, v in kw.items()
                if k in ("npop", "ordered", "lean", "leaf_stack", "slim",
                         "sub", "noinst")}
    ref = lab.trace_lab_plain(sw.nodes, sw.tris, sw.attrs, sw.inv_mats, o,
                              d, 0.0, t_max, 16, stack, boxes=boxes,
                              **plain_kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert int(totals[0]) > 0 and int(totals[1]) > 0
    _hold(got[0], got[4], ref[0], ref[4], t_max, got[5], ref[5])
    # u, v and the normal where the ids agree: u = u*det / det amplifies the
    # kernel's fmad rounding at grazing hits, so >= 99% within 1e-4
    agree = (got[4] == ref[4]) & (got[5] == ref[5]) & (ref[4] >= 0)
    for a, b in zip(got[1:4], ref[1:4]):
        err = (a[agree] - b[agree]).abs().reshape(int(agree.sum()), -1)
        assert float((err <= 1e-4).all(dim=1).float().mean()) >= 0.99
    assert int(ref[6][:, 2].max()) < stack          # no push was dropped
    st = got[6]
    if not kw.get("stats"):
        assert st is None
        return
    assert st.shape == (4096, 2) and not bool(st[t_max < 0].any())
    assert float((st == ref[6][:, :2]).all(dim=1).float().mean()) >= 0.99


@pytest.mark.parametrize("leaf_size,tile_s", [(16, 8), (32, 8), (32, 32)])
def test_mxu_kernel_matches_plain(cuda, leaf_size, tile_s):
    from raytracedggx_tpu_torch.ops.lab import fused_mxu as mxu
    from raytracedggx_tpu_torch.ops.lab.fused_lab import stack_bound

    sw = _model_bvh(cuda, leaf_size)
    o, d, t_max = _model_rays(cuda)
    coef = mxu.mxu_stream(sw)
    n0 = mxu.trace_tiles_mxu.launches
    got = mxu.trace_tiles_mxu(sw.nodes, coef, sw.inv_mats, sw.inst_slots, o,
                              d, 0.0, t_max, leaf_size,
                              stack_bound(sw.depth, 2), tile_s)
    ref = mxu.trace_mxu_plain(coef, sw.inv_mats, sw.inst_slots, o, d, 0.0,
                              t_max, leaf_size)
    k1 = _k1(sw, o, d, t_max)
    torch.cuda.synchronize()
    assert mxu.trace_tiles_mxu.launches == n0 + 1
    _hold(got[0], got[3], ref[0], ref[3], t_max, got[4], ref[4])
    _hold(got[0], got[3], k1[0], k1[3], t_max, got[4], k1[4])


def test_lab_wrappers_refuse_bad_inputs(cuda):
    from raytracedggx_tpu_torch.ops.lab import fused_lab as lab
    from raytracedggx_tpu_torch.ops.lab import fused_mxu as mxu

    sw = _model_bvh(cuda, 16)
    o, d, t_max = _model_rays(cuda, 64)
    with pytest.raises(ValueError):                  # above the kernel's
        lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats, o, d, 0.0,
                            t_max, 16, stack=10 ** 6, attrs=sw.attrs)
    with pytest.raises(ValueError):                  # attrs on the CPU
        lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats, o, d, 0.0,
                            t_max, 16, attrs=sw.attrs.cpu())
    with pytest.raises(ValueError):                  # coef of another L
        mxu.trace_tiles_mxu(sw.nodes, mxu.mxu_stream(sw), sw.inv_mats,
                            sw.inst_slots, o, d, 0.0, t_max, 8)
    with pytest.raises(ValueError):                  # beyond shared memory
        mxu.trace_tiles_mxu(sw.nodes, mxu.mxu_stream(sw), sw.inv_mats,
                            sw.inst_slots, o, d, 0.0, t_max, 16, 114, 32)
    with pytest.raises(ValueError):                  # with the staged rows
        lab.trace_tiles_lab(sw.nodes, sw.tris4, sw.inv_mats, o, d, 0.0,
                            t_max, 16, stack=113, tile_s=32,
                            smem_nodes=True, attrs=sw.attrs)
    with pytest.raises(ValueError):                  # rows not 16-aligned
        lab.trace_tiles_lab(sw.nodes, _shifted(sw.tris4), sw.inv_mats, o, d,
                            0.0, t_max, 16, stack=8, attrs=sw.attrs)


def _shifted(rows):
    """A copy of rows whose storage starts 4 bytes past a 16-byte line."""
    buf = torch.empty(rows.numel() + 1, dtype=rows.dtype,
                      device=rows.device)
    out = buf[1:].view(rows.shape)
    out.copy_(rows)
    return out


def _full_tree(device, depth=5, leaves=False):
    """A full 4-ary tree of ``depth`` levels whose boxes all hold the
    origin (the bottom level's children empty, or with ``leaves`` each a
    leaf of the one pad slot), one pad slot: every ray from the origin
    pushes every internal child."""
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
    return tuple(x.to(device) for x in (
        nodes, tris, torch.full((1, 12), float("nan")), torch.zeros((1, 10)),
        torch.eye(4)[:, :3].reshape(1, 12)))


@pytest.mark.parametrize("npop", [1, 2, 4, "leaf_stack"])
@pytest.mark.parametrize("half", [False, True])
def test_lab_shared_stack_fills_and_drops_as_plain(cuda, npop, half):
    """K6a on a full tree of depth 5, where the walk's stack comes near
    its bound (at npop 1 it reaches it), and K6b on the same tree with
    leaves under its bottom nodes (where it reaches its bound), with the
    capacity at the bound and at half of it (pushes onto the full stack
    dropped): per-ray node and leaf visits equal the plain version's, at
    several thread counts of a block."""
    from raytracedggx_tpu_torch.ops.lab import fused_lab as lab

    ls = npop == "leaf_stack"
    npop = 2 if ls else npop
    nodes, tris, tris4, attrs, inv = _full_tree(cuda, leaves=ls)
    rng = np.random.default_rng(npop)
    n = 1000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.zeros((n, 3), device=cuda)
    d = torch.as_tensor(d, device=cuda)
    t_max = torch.where(torch.arange(n, device=cuda) % 5 == 0, -1.0, 1e4)
    stack = ((lab.ls_stack_bound(5) if ls else lab.stack_bound(5, npop))
             // (2 if half else 1))
    ref = lab.trace_lab_plain(nodes, tris, attrs, inv, o, d, 0.0, t_max, 1,
                              stack, npop, leaf_stack=ls)
    assert int(ref[6][:, 2].max()) <= stack
    if ls and not half:
        assert int(ref[6][:, 2].max()) == stack
    for tile_s in (2, 8, 32):
        got = lab.trace_tiles_lab(nodes, tris4, inv, o, d, 0.0, t_max, 1,
                                  stack=stack, tile_s=tile_s, stats=True,
                                  npop=npop, leaf_stack=ls, attrs=attrs)
        torch.cuda.synchronize()
        assert torch.equal(got[6], ref[6][:, :2])
        assert not bool((got[4] >= 0).any())


def test_lab_kernels_have_no_frame_or_spills(cuda):
    """ptxas gives every K6a and K6b instance and K7 no stack frame and no
    spills (their stacks sit in shared memory)."""
    from raytracedggx_tpu_torch.ops import cuda_lib

    reports = cuda_lib.ptxas_reports(cuda_lib.build()[1])
    for key, n in (("lab_kernel", 6), ("ls_kernel", 2), ("mxu_kernel", 1)):
        rows = [r for name, r in reports.items() if key in name]
        assert len(rows) == n and all(r[1:] == (0, 0, 0) for r in rows), \
            (key, rows)


def _modes(sw, o, d, t_max, t_min=0.0):
    """(lean, slim, fat) outputs of K1's three modes on the same rays."""
    args = (sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, o, d, t_min,
            t_max, sw.leaf_size, sw.k1_stack)
    return (fused.trace_tiles_instanced(*args),
            fused.trace_tiles_instanced(*args, slim=True),
            fused.trace_tiles_instanced(*args, lean=False,
                                        attrs4=fused.attrs4_rows(sw.attrs)))


def _hold_modes(sw, o, d, t_max, t_min=0.0):
    """K1s and K1f against lean K1 (hit mask, slot or prim and inst exact,
    t at rtol 1e-6; the fat u, v equal to lean's, its normal equal bit for
    bit to slot_normals of its own u, v, and at atol 1e-5 of lean's) and against their plain
    versions at the traversal bar; K1e on K1s's slot and inst gives lean's
    u, v bit for bit (the walk's arithmetic)."""
    lean, slim, fat = _modes(sw, o, d, t_max, t_min)
    n0 = fused.slim_uv.launches
    u, v = fused.slim_uv(sw.tris4, sw.inv_mats, o, d, slim[1], slim[2])
    assert fused.slim_uv.launches == n0 + 1
    assert torch.equal(u, lean[1]) and torch.equal(v, lean[2])
    hit = lean[3] >= 0
    nrm, prim = fused.slot_normals(sw.attrs, lean[3], lean[1], lean[2])
    for got, got_id, want_id in ((slim, slim[1], lean[3]),
                                 (fat, fat[4], prim)):
        assert torch.equal(got_id, want_id) and torch.equal(got[-1], lean[4])
        torch.testing.assert_close(got[0], lean[0], rtol=1e-6, atol=0)
    # the same walk and leaf test as lean: u, v equal bit for bit
    assert torch.equal(fat[1], lean[1]) and torch.equal(fat[2], lean[2])
    assert torch.equal(fat[3], fused.slot_normals(sw.attrs, lean[3], fat[1],
                                                  fat[2])[0])
    torch.testing.assert_close(fat[3][hit], nrm[hit], rtol=0, atol=1e-5)
    ref_s = fused.trace_instanced_plain(sw.tris, sw.inv_mats, sw.inst_slots,
                                        o, d, t_min, t_max, slim=True)
    ref_f = fused.trace_instanced_plain(sw.tris, sw.inv_mats, sw.inst_slots,
                                        o, d, t_min, t_max, lean=False,
                                        attrs=sw.attrs)
    torch.cuda.synchronize()
    _hold(slim[0], slim[1], ref_s[0], ref_s[1], t_max, slim[2], ref_s[2])
    _hold(fat[0], fat[4], ref_f[0], ref_f[4], t_max, fat[5], ref_f[5])


@pytest.mark.parametrize("leaf_size", [8, 64])
@pytest.mark.parametrize("n_extra", [0, 7])
def test_k1_slim_and_fat_modes_match_lean_and_plain(cuda, n_extra,
                                                    leaf_size):
    """K1s and K1f on the cube scene with 2 or 9 instances; each launch
    counts on its own mode's counter."""
    rng = np.random.default_rng(11)
    extra = tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
                  for i in range(n_extra))
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                  extra_instances=extra)
    sw = build_scene_wide(upload_scene(scene, cuda), scene.mesh_ids,
                          leaf_size=leaf_size, device=cuda)
    sw = refit_scene_wide(sw, scene.worlds(1.3).to(cuda))
    o, d = _rand_rays(rng, 4096, cuda)
    t_max = torch.where(torch.arange(4096, device=cuda) % 3 == 0, -1.0, 1e4)
    k = fused.trace_tiles_instanced
    n0 = (k.launches, k.launches_slim, k.launches_fat)
    _hold_modes(sw, o, d, t_max)
    assert (k.launches, k.launches_slim, k.launches_fat) == tuple(
        n + 1 for n in n0)


def test_k1_modes_match_on_model(cuda):
    """K1s and K1f on the 5,120-triangle stand-in at the renderer's leaf
    size, from a secondary wave's t_min."""
    sw = _model_bvh(cuda, 8)
    o, d, t_max = _model_rays(cuda)
    _hold_modes(sw, o, d, t_max, 1e-4)


def test_k1_mode_wrapper_refuses_bad_inputs(cuda):
    """slim needs the lean layout, fat its 16-byte aligned (S, 12) attrs4
    rows, K1e int32 slot and inst of the rays' count and (S, 12) rows;
    nothing launches."""
    sw = _model_bvh(cuda, 8)
    o, d, t_max = _model_rays(cuda, 64)
    args = (sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, o, d, 0.0,
            t_max, sw.leaf_size, sw.k1_stack)
    k = fused.trace_tiles_instanced
    n0 = (k.launches, k.launches_slim, k.launches_fat)
    attrs4 = fused.attrs4_rows(sw.attrs)
    shifted = torch.empty(attrs4.numel() + 1, device=cuda)[1:]
    shifted.copy_(attrs4.reshape(-1))
    for kw in (dict(slim=True, lean=False, attrs4=attrs4),
               dict(lean=False), dict(lean=False, attrs4=sw.attrs),
               dict(lean=False, attrs4=shifted.reshape(-1, 12))):
        with pytest.raises(ValueError):
            k(*args, **kw)
    assert (k.launches, k.launches_slim, k.launches_fat) == n0
    slot = torch.zeros(64, dtype=torch.int32, device=cuda)
    n1 = fused.slim_uv.launches
    for bad in (dict(slot=slot.long()), dict(inst=slot[:63]),
                dict(tris4=sw.tris)):
        kw = dict(tris4=sw.tris4, inv_mats=sw.inv_mats, ray_o=o, ray_d=d,
                  slot=slot, inst=slot)
        kw.update(bad)
        with pytest.raises(ValueError):
            fused.slim_uv(**kw)
    assert fused.slim_uv.launches == n1


def test_k1_instances_have_no_frame_or_spills(cuda):
    """ptxas gives K1's lean, slim and fat instances no stack frame and
    no spills."""
    from raytracedggx_tpu_torch.ops import cuda_lib

    reports = cuda_lib.ptxas_reports(cuda_lib.build()[1])
    rows = [r for name, r in reports.items()
            if "trace_instanced_kernel" in name]
    assert len(rows) == 3 and all(r[1:] == (0, 0, 0) for r in rows), rows


def _cube_renderer(device, **cfg):
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer

    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32))
    return Renderer(scene, config=RenderConfig(width=96, height=54, **cfg),
                    device=device)


def _same_frames(a, b):
    (sa, fa), (sb, fb) = a, b
    torch.cuda.synchronize()
    assert torch.equal(fa, fb) and torch.equal(sa.history, sb.history)
    assert torch.equal(sa.prev_wvp, sb.prev_wvp) and sa.frame == sb.frame


@pytest.mark.parametrize("cfg,per_frame", [
    (dict(traversal="wide"), ("K1", 2, 3, 4, 4, 1, 2)),
    (dict(traversal="wide", trace_slim=True), ("K1s", 2, 3, 4, 4, 1, 2)),
    (dict(traversal="pallas4"), ("K5", 4, 6, 5, 6, 0, 0)),
    (dict(traversal="pallas"), ("K4", 4, 6, 5, 6, 0, 0)),
])
def test_step_n_capture_equals_step_loop(cuda, cfg, per_frame):
    """step_n replays one captured frame; its frames and states equal a
    step loop's bit for bit, at metallic 1 and, across a set_metallic
    that opens the gates (a new capture), at 0.5; the captured frame's
    launches are the path's (K2 twice; K3 twice at metallic 0.5; XF four
    times in the primary wave, and on the per-mesh routes once in each
    bounce wave; BS once in each bounce wave on K1's route; TS once a
    frame in the step loop and once in the captured frame)."""
    from raytracedggx_tpu_torch.ops.temporal_cuda import temporal_ss

    r = _cube_renderer(cuda, **cfg)
    assert r.captures
    s_loop = s_chunk = r.init_state()
    kernel, n1, n05, xf1, xf05, bs1, bs05 = per_frame
    for n, metallic in ((4, None), (3, 0.5)):
        if metallic is not None:
            r.set_metallic(0, metallic)
            r.set_metallic(1, metallic)
        ts0 = temporal_ss.launches
        for _ in range(n):
            s_loop, f_loop, _ = r.step(s_loop, 1 / 30)
        assert temporal_ss.launches == ts0 + n
        s_chunk, f_chunk = r.step_n(s_chunk, n, 1 / 30)
        _same_frames((s_loop, f_loop), (s_chunk, f_chunk))
        want = n05 if metallic else n1
        got = r.capture_launches
        assert got[kernel] == want and got["K2"] == 2, got
        assert got["K3"] == (2 if metallic else 0), got
        assert got["XF"] == (xf05 if metallic else xf1), got
        assert got["BS"] == (bs05 if metallic else bs1), got
        assert got["TS"] == 1, got


def test_step_n_capture_after_set_kernels_xla_launches_no_k2(cuda):
    """set_kernels("xla") captures the frame again, with the plain
    filter passes: the captured frame launches K1 twice and no K2."""
    r = _cube_renderer(cuda)
    state, _ = r.step_n(r.init_state(), 2)
    assert r.capture_launches["K2"] == 2
    r.set_kernels("xla")
    n_k2 = spatial_cuda.reflection_pass.launches
    loop, f_loop = state, None
    for _ in range(2):
        loop, f_loop, _ = r.step(loop)
    chunk = r.step_n(state, 2)
    assert r.capture_launches["K2"] == 0 and r.capture_launches["K1"] == 2
    assert spatial_cuda.reflection_pass.launches == n_k2
    _same_frames((loop, f_loop), chunk)


def test_async_compute_equals_sync(cuda):
    """The refit on a second stream renders the same frames as on the
    frame's own stream, bit for bit."""
    r = _cube_renderer(cuda, async_compute=True)
    frames = {}
    for on in (True, False):
        r.set_async_compute(on)
        state = r.init_state()
        for _ in range(3):
            state, frame, _ = r.step(state, 1 / 30)
        frames[on] = (state, frame)
    _same_frames(frames[True], frames[False])


def test_step_n_raises_when_the_capture_fails(cuda):
    """A frame that reads a tensor back (here a trace_hook) cannot be
    captured: step_n raises, in a process of its own (a failed capture
    may leave the context unusable)."""
    import subprocess
    import sys

    code = """
import numpy as np, torch
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
scene = Scene(meshes=[ground_cube(), ground_cube()],
              materials=default_materials(),
              pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32))
r = Renderer(scene, config=RenderConfig(width=96, height=54))
r.trace_hook = lambda sw, o, d, t_min, t_max: float(o.sum())
try:
    r.step_n(r.init_state(), 2)
except RuntimeError:
    print("step_n raised")
else:
    print("captured")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert "step_n raised" in res.stdout, res.stdout + res.stderr


def _bands_against_renderer(mesh, metallic, cuda):
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.engine.renderer import launch_counts
    from raytracedggx_tpu_torch.parallel import ShardedRenderer

    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32))
    cfg = RenderConfig(width=128, height=128)
    single = Renderer(scene, config=cfg, device=cuda)
    bands = ShardedRenderer(scene, mesh=mesh, halo=32, config=cfg)
    out = []
    for r in (single, bands):
        for mesh_idx in (0, 1):
            r.set_metallic(mesh_idx, metallic)
        n0 = launch_counts()
        state = r.init_state()
        for _ in range(3):
            state, frame, _ = r.step(state)
        for dev in {torch.device(d) for d in mesh}:
            torch.cuda.synchronize(dev)
        n1 = launch_counts()
        out.append((state, frame, {k: n1[k] - n0[k] for k in
                                   ("K1", "K2", "K3", "XF", "TS", "BS")}))
    (_, f1, c1), (s2, f2, c2) = out
    assert f2.shape == (128, 128, 3) and f2.device == cuda
    assert float((f1 - f2).abs().max()) < 5e-4
    assert len(s2.history) == 4 and all(
        b.shape == (32, 128, 4) and b.dtype == torch.float16
        and b.device == torch.device(d)
        for b, d in zip(s2.history, mesh))
    want = {"K1": 2, "K2": 2, "K3": 0, "XF": 4, "TS": 1, "BS": 1} \
        if metallic == 1.0 else {"K1": 3, "K2": 2, "K3": 2, "XF": 4, "TS": 1,
                                 "BS": 2}
    assert c1 == {k: 3 * n for k, n in want.items()}
    assert c2 == {k: 4 * n for k, n in c1.items()}


@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_bands_on_the_card_match_renderer(cuda, metallic):
    """4 row bands of 32 rows on one card (halo 32, the index-order route:
    96 rows) against the single-device frame at 128x128 over 3 frames:
    within one f16 ulp, the history in 4 f16 bands, and K1, K2, XF, TS and
    BS (K3 at metallic 0.5) launched 4x per frame."""
    _bands_against_renderer((cuda,) * 4, metallic, cuda)


@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_bands_across_cards_match_renderer(cuda, metallic):
    """The same 4 bands dealt round-robin over every card of the machine:
    each band's kernels launch on its own card, the halos are peer copies,
    and the frame comes back to the first card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    _bands_against_renderer(
        tuple(torch.device("cuda", i % n) for i in range(4)), metallic, cuda)


# XF: the call forms of trace/raygen.py, as (table rows x cols, affine,
# output columns)
XF_FORMS = {"normal": (3, False, None), "to_object": (4, True, None),
            "clip": (4, True, 4)}


def _xf_inputs(rng, rows, form, inst_dtype, strided, device, n=50_000):
    """A table of ``rows`` random matrices, ids in [-1, rows) (-1 a miss)
    and 3-vectors; strided: x and inst as the columns of wider rows, as
    a wave's un-permuted rows hand them over, and the table a transposed
    view."""
    t, _, _ = XF_FORMS[form]
    table = torch.as_tensor(rng.normal(0.0, 2.0, (rows, t, t)),
                            dtype=torch.float32, device=device)
    ids = torch.as_tensor(rng.integers(-1, rows, n), dtype=inst_dtype,
                          device=device)
    xs = torch.as_tensor(rng.normal(0.0, 5.0, (n, 3)), dtype=torch.float32,
                         device=device)
    if strided:
        table = table.transpose(1, 2).contiguous().transpose(1, 2)
        ids = torch.stack([torch.zeros_like(ids), ids], dim=-1)[:, 1]
        xs = torch.cat([torch.zeros_like(xs), xs], dim=-1)[:, 3:6]
    return table, ids, xs


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("inst_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("form", list(XF_FORMS))
def test_xform_kernel_matches_plain(cuda, form, rows, inst_dtype, strided):
    """XF against its plain version (the take_small + einsum it
    replaced), misses included.  Tolerance: each output within 2 float32
    ulp (2 * 2**-23) of its operands' magnitude, sum_c |x_c M_cd| (+
    |M_3d| where affine): each side rounds at most 4 times, by half an ulp
    of a partial sum no larger than that magnitude, in another order."""
    from raytracedggx_tpu_torch.trace.shade import take_small

    rng = np.random.default_rng(rows * 10 + len(form))
    _, affine, cols = XF_FORMS[form]
    table, ids, xs = _xf_inputs(rng, rows, form, inst_dtype, strided, cuda)
    n0 = xform_cuda.instance_xform.launches
    got = xform_cuda.instance_xform(table, ids, xs, affine, cols)
    ref = xform_cuda.instance_xform_plain(table, ids, xs, affine, cols)
    torch.cuda.synchronize()
    assert xform_cuda.instance_xform.launches == n0 + 1
    assert got.shape == ref.shape == (xs.shape[0], cols or 3)
    assert got.is_contiguous() and got.dtype == torch.float32
    m = take_small(table, ids).double().abs()
    d = got.shape[1]
    mag = torch.einsum("nc,ncd->nd", xs.double().abs(), m[:, :3, :d])
    if affine:
        mag = mag + m[:, 3, :d]
    err = (got.double() - ref.double()).abs()
    assert bool((err <= 2.0 * 2.0 ** -23 * mag).all()), float(
        (err / mag).max())


def test_xform_wrapper_refuses_bad_inputs(cuda):
    """A CUDA tensor never falls back to the plain version: another
    device, dtype or shape, or more rows than shared memory holds,
    raises."""
    rng = np.random.default_rng(3)
    table, ids, xs = _xf_inputs(rng, 2, "to_object", torch.int64, False,
                                cuda, n=64)
    xf = xform_cuda.instance_xform
    bad = [
        (table.cpu(), ids, xs, True, None),              # device
        (table, ids.cpu(), xs, True, None),
        (table.double(), ids, xs, True, None),           # dtype
        (table, ids, xs.double(), True, None),
        (table, ids.float(), xs, True, None),
        (table, ids, xs, False, None),                   # shape
        (table[:, :3, :3], ids, xs, True, None),
        (table, ids, xs, True, 2),
        (table, ids[:-1], xs, True, None),
        (table, ids, xs[:, :2], True, None),
        (table, ids, xs[None], True, None),
        (table[:0], ids, xs, True, None),                # rows
        (table[:1].expand(xform_cuda.max_rows() + 1, 4, 4), ids, xs,
         True, None),
    ]
    n0 = xf.launches
    for args in bad:
        with pytest.raises(ValueError):
            xf(*args)
    assert xf.launches == n0


def test_xform_kernel_has_no_frame_or_spills(cuda):
    """ptxas gives XF's three instances no stack frame and no spills."""
    from raytracedggx_tpu_torch.ops import cuda_lib

    reports = cuda_lib.ptxas_reports(cuda_lib.build()[1])
    rows = [r for name, r in reports.items()
            if "instance_xform_kernel" in name]
    assert len(rows) == 3 and all(r[1:] == (0, 0, 0) for r in rows), rows


# TS: the TAA (ops/temporal_cuda.py, csrc/temporal.cu)
def _ts_inputs(rng, h, w, device, hist_dtype=torch.float16, motion=0.002):
    """TS's inputs as a frame hands them over (chip_smoke.py:ts_inputs):
    HDR colour whose alpha, the hit flag, is 1 inside an ellipse and 0
    outside (cur_a <= 0); velocities of ``motion`` viewports, one pixel in
    64 thrown up to 1.5 viewports (past every border); a history with
    counts k / 15; NaN in one history pixel in 4096 and one more (the
    result's NaN fallback), and in one colour value."""
    cur = rng.uniform(0.0, 4.0, (h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    cur[..., 3] = (((yy - h / 2) / (0.4 * h)) ** 2
                   + ((xx - w / 2) / (0.4 * w)) ** 2) < 1.0
    vel = rng.normal(0.0, motion, (h, w, 2)).astype(np.float32)
    far = rng.random((h, w)) < 1 / 64
    vel[far] = rng.uniform(-1.5, 1.5, (int(far.sum()), 2))
    hist = rng.uniform(0.0, 4.0, (h, w, 4)).astype(np.float32)
    hist[..., 3] = rng.integers(0, 16, (h, w)) / 15.0
    hist[rng.random((h, w)) < 1 / 4096, 1] = np.nan
    hist[h // 4, w // 4, 1] = np.nan
    cur[h // 2, w // 2, 0] = np.nan
    return (torch.as_tensor(cur, device=device),
            torch.as_tensor(hist, device=device).to(hist_dtype),
            torch.as_tensor(vel, device=device))


def _ts_same(got, ref):
    """Bit for bit, a NaN where the other has a NaN."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    same = (got.view(torch.int32) == ref.view(torch.int32)) \
        | (got.isnan() & ref.isnan())
    bad = ~same
    assert not bool(bad.any()), (
        f"{int(bad.sum())} values differ, max |diff| "
        f"{float((got - ref).abs()[bad].nan_to_num(0.0).max()):.3e}")


@pytest.mark.parametrize("hist_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("hw", [(720, 1280), (2160, 3840), (37, 67)])
def test_temporal_kernel_matches_plain(cuda, hw, hist_dtype):
    """TS against its plain version (denoise/temporal.py:temporal_ss),
    bit for bit, with one launch: reprojections that clamp at every
    border, pixels with cur_a <= 0; then at rest, where a NaN in a
    pixel's history takes the NaN fallback (a finite result)."""
    from raytracedggx_tpu_torch.denoise.temporal import temporal_ss as plain
    from raytracedggx_tpu_torch.ops.temporal_cuda import temporal_ss

    h, w = hw
    rng = np.random.default_rng(h + w)
    cur, hist, vel = _ts_inputs(rng, h, w, cuda, hist_dtype)
    n0 = temporal_ss.launches
    got = temporal_ss(cur, hist, vel)
    ref = plain(cur, hist, vel)
    torch.cuda.synchronize()
    assert temporal_ss.launches == n0 + 1
    assert got.is_contiguous() and got.device == cuda
    _ts_same(got, ref)
    ys, xs = torch.meshgrid(torch.arange(h, device=cuda),
                            torch.arange(w, device=cuda), indexing="ij")
    qx, qy = xs - vel[..., 0] * w, ys - vel[..., 1] * h
    assert bool((qx < 0).any() and (qx > w - 1).any() and (qy < 0).any()
                and (qy > h - 1).any())
    assert bool((cur[..., 3] <= 0).any() and (cur[..., 3] > 0).any())
    still = torch.zeros_like(vel)      # each pixel reads its own history
    ref = plain(cur, hist, still)
    _ts_same(temporal_ss(cur, hist, still), ref)
    fallback = hist.isnan().any(-1) & ~ref.isnan().any(-1)
    assert bool(fallback.any())


@pytest.mark.parametrize("row0", [-5, 0, 10])
def test_temporal_kernel_matches_plain_on_a_band(cuda, row0):
    """A band of 37 rows of a 47-row image from row ``row0`` (negative:
    the first band, starting in its halo), its velocity a strided view:
    bit for bit the plain version."""
    from raytracedggx_tpu_torch.denoise.temporal import temporal_ss as plain
    from raytracedggx_tpu_torch.ops.temporal_cuda import temporal_ss

    rng = np.random.default_rng(50 + row0)
    cur, hist, vel = _ts_inputs(rng, 37, 67, cuda, motion=0.1)
    vel = torch.cat([vel, vel], dim=-1)[..., 1:3]
    assert not vel.is_contiguous()
    got = temporal_ss(cur, hist, vel, full_size=(67, 47), row0=row0)
    ref = plain(cur, hist, vel, full_size=(67, 47), row0=row0)
    _ts_same(got, ref)


def test_temporal_wrapper_refuses_bad_inputs(cuda):
    """A CUDA tensor never falls back to the plain version: another
    device, dtype or shape raises, before any launch."""
    from raytracedggx_tpu_torch.ops.temporal_cuda import temporal_ss

    cur, hist, vel = _ts_inputs(np.random.default_rng(5), 9, 11, cuda)
    bad = [(cur, hist.cpu(), vel), (cur, hist, vel.cpu()),
           (cur.double(), hist, vel), (cur, hist.bfloat16(), vel),
           (cur, hist, vel.half()), (cur[..., :3], hist, vel),
           (cur, hist[:-1], vel), (cur, hist, vel[..., :1]),
           (cur[None], hist, vel)]
    n0 = temporal_ss.launches
    for args in bad:
        with pytest.raises(ValueError):
            temporal_ss(*args)
    assert temporal_ss.launches == n0


def test_temporal_kernel_has_no_frame_or_spills(cuda):
    """ptxas gives TS's two instances (f16 and f32 history) no stack frame
    and no spills."""
    from raytracedggx_tpu_torch.ops import cuda_lib

    reports = cuda_lib.ptxas_reports(cuda_lib.build()[1])
    rows = [r for name, r in reports.items() if "temporal_ss_kernel" in name]
    assert len(rows) == 2 and all(r[1:] == (0, 0, 0) for r in rows), rows


# BS: the bounce waves' shading (ops/shade_cuda.py, csrc/shade.cu)
def _bs_waves(monkeypatch, cuda, hw, metallic):
    """Every shade_bounce call of one eager frame of the cube scene over
    8 instances (the 4K cell's layout of 6 extra copies) at ``hw``, with
    mesh 0 (instance 0: the checkerboard) and mesh 1 at ``metallic``:
    [(args, BS rows, plain rows)], the sorted waves as K1 hands them
    over."""
    import raytracedggx_tpu_torch.trace.raygen as raygen
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.ops import shade_cuda

    calls = []

    def spy(*args):
        out = shade_cuda.shade_bounce(*args)
        calls.append((args, out, shade_cuda.shade_bounce_plain(*args)))
        return out
    monkeypatch.setattr(raygen, "shade_bounce", spy)
    extra = tuple((2.5 * (i % 3) - 2.5, 0.0, 2.5 * (i // 3) - 2.5, 0.6)
                  for i in range(1, 7))
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32),
                  extra_instances=extra)
    r = Renderer(scene, config=RenderConfig(width=hw[1], height=hw[0]),
                 device=cuda)
    for mesh_idx, m in enumerate(metallic):
        r.set_metallic(mesh_idx, m)
    r.step(r.init_state(), 1 / 30)
    torch.cuda.synchronize()
    return calls


@pytest.mark.parametrize("metallic", [(1.0, 1.0), (0.5, 1.0)])
@pytest.mark.parametrize("hw", [(720, 1280), (2160, 3840)])
def test_shade_kernel_matches_plain_on_the_waves(monkeypatch, cuda, hw,
                                                 metallic):
    """BS against its plain version on a frame's sorted bounce waves over
    8 instances, at 1280x720 and 3840x2160: the reflection wave and, with
    the ground at metallic 0.5, the damped diffuse wave; bit for bit, one
    launch a wave, hits, misses and dead rays among the rays."""
    from raytracedggx_tpu_torch.ops import shade_cuda

    n0 = shade_cuda.shade_bounce.launches
    calls = _bs_waves(monkeypatch, cuda, hw, metallic)
    assert [a[-1] for a, _, _ in calls] == (
        [False, True] if min(metallic) < 1.0 else [False])
    assert shade_cuda.shade_bounce.launches == n0 + len(calls)
    for args, got, ref in calls:
        rec = args[4]
        assert got.shape == (hw[0] * hw[1], 4) and got.is_contiguous()
        assert bool(rec.hit.any()) and bool((rec.inst == -1).any())
        _ts_same(got, ref)


def test_shade_wrapper_refuses_bad_inputs(monkeypatch, cuda):
    """A CUDA wave never falls back to the plain version: a table or the
    env on another device, another dtype or shape raises before any
    launch; the wrapper's row and mip limits are the kernel's."""
    from raytracedggx_tpu_torch.ops import cuda_lib, shade_cuda

    args = _bs_waves(monkeypatch, cuda, (54, 96), (1.0, 1.0))[0][0]
    consts, mats, env, sh, rec, nrm, o, d, _ = args
    bad = [
        (consts._replace(inv_worlds=consts.inv_worlds.cpu()), mats, env, sh,
         rec, nrm, o, d),
        (consts, mats, env._replace(tri=env.tri.cpu()), sh, rec, nrm, o, d),
        (consts, mats, env, sh.cpu(), rec, nrm, o, d),
        (consts, mats, env, sh, rec._replace(t=rec.t.double()), nrm, o, d),
        (consts, mats, env, sh, rec._replace(hit=rec.hit.int()), nrm, o, d),
        (consts, mats, env, sh, rec, nrm.half(), o, d),
        (consts, mats, env, sh, rec, nrm[:-1], o, d),
        (consts, mats, env, sh, rec, nrm, o[:, :2], d),
        (consts, mats, env._replace(tri=env.tri[:, :12]), sh, rec, nrm, o,
         d),
        (consts, mats._replace(rough_metals=mats.rough_metals[:0]), env, sh,
         rec, nrm, o, d),
    ]
    n0 = shade_cuda.shade_bounce.launches
    for a in bad:
        with pytest.raises(ValueError):
            shade_cuda.shade_bounce(*a, False)
    assert shade_cuda.shade_bounce.launches == n0
    lib = cuda_lib.load_library()
    assert (lib.rtggx_shade_max_rows(), lib.rtggx_shade_max_mips()) == (
        shade_cuda.MAX_ROWS, shade_cuda.MAX_MIPS)


def test_shade_kernel_has_no_frame_or_spills(cuda):
    """ptxas gives BS no stack frame and no spills."""
    from raytracedggx_tpu_torch.ops import cuda_lib

    reports = cuda_lib.ptxas_reports(cuda_lib.build()[1])
    rows = [r for name, r in reports.items()
            if "bounce_shade_kernel" in name]
    assert len(rows) == 1 and all(r[1:] == (0, 0, 0) for r in rows), rows
