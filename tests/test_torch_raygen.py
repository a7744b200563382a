"""PyTorch port parity, the ray-trace pass (primary, reflection and
diffuse waves with their shading and composite).

Both sides trace with the brute-force closest-hit contract of K1 (ties
to the lowest instance and stream slot): the port with K1's plain
version, the JAX package with ``jax_bruteforce_fused`` below in place of
its Pallas kernel, whose own parity tests/test_torch_scene_wide.py
checks.  So this file tests everything around the traversal: ray
generation, sorting, shading, the env and SH lookups and the composite.
Bar: ``vis`` agrees on >= 99% of pixels; where it agrees, the G-buffers
and radiances match at atol 1e-4."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.bvh import build_tlas as j_build_tlas
from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.ops.traverse_pallas import make_block_order as j_order
from raytracedggx_tpu.scene import Camera as JCamera
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.sh import project_sh9 as j_project_sh9
from raytracedggx_tpu.trace import raygen as jr
from raytracedggx_tpu.trace.env import procedural_env as j_env
from raytracedggx_tpu.trace.geometry import SceneGeometry as JGeometry
from raytracedggx_tpu.trace.geometry import upload_mesh as j_upload_mesh
from raytracedggx_tpu.trace.traverse import HitRecord as JHitRecord
from raytracedggx_tpu.utils import math3d as jm3

from raytracedggx_tpu_torch.bvh import build_tlas
from raytracedggx_tpu_torch.ops.ordering import make_block_order
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.scene import Materials, Scene, ground_cube
from raytracedggx_tpu_torch.trace import raygen as tr
from raytracedggx_tpu_torch.trace.env import from_reference_arrays
from raytracedggx_tpu_torch.trace.geometry import upload_scene

W, H = 32, 18


def _instance_slots(sw):
    """[(inst, stream slots)] under each kind-3 entry of the top tree."""
    cols = np.asarray(sw.static_cols).astype(np.int64)
    kind, a, b = cols[:, 0:4], cols[:, 4:8], cols[:, 8:12]
    L = int(sw.leaf_size)
    out = []
    for r in range(int(sw.n_top)):
        for k in range(4):
            if kind[r, k] != 3:
                continue
            leaves, todo = [], [a[r, k]]
            while todo:
                n = todo.pop()
                leaves += [a[n, c] for c in range(4) if kind[n, c] == 1]
                todo += [a[n, c] for c in range(4) if kind[n, c] == 2]
            leaves = np.sort(np.asarray(leaves))
            out.append((int(b[r, k]) - 1,
                        (leaves[:, None] * L + np.arange(L)).reshape(-1)))
    return sorted(out, key=lambda e: e[0])


def jax_bruteforce_fused(sw, ray_o, ray_d, t_min, t_max, interpret=False,
                         slim=False):
    """JAX twin of K1's contract on the reference's SceneWideBVH, with the
    signature and outputs of its trace_scene_wide_fused (lean): brute-force
    Moller-Trumbore over every (instance, stream slot) pair, ties to the
    lowest (inst, slot)."""
    del interpret, slim
    rows = np.asarray(sw.tris).transpose(0, 2, 1).reshape(-1, 9)
    R = ray_o.shape[0]
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    best_u = best_v = jnp.zeros((R,), jnp.float32)
    best_s = best_i = jnp.full((R,), -1, jnp.int32)
    for inst, slots in _instance_slots(sw):
        g = jnp.asarray(rows[slots])
        v0, e1, e2 = g[None, :, 0:3], g[None, :, 3:6], g[None, :, 6:9]
        m = sw.inv_mats[inst + 1]
        o = (ray_o[:, 0:1] * m[0:3] + ray_o[:, 1:2] * m[3:6]
             + ray_o[:, 2:3] * m[6:9] + m[9:12])[:, None]
        d = (ray_d[:, 0:1] * m[0:3] + ray_d[:, 1:2] * m[3:6]
             + ray_d[:, 2:3] * m[6:9])[:, None]
        pv = jnp.cross(d, e2)
        inv_det = 1.0 / jnp.sum(e1 * pv, axis=-1)
        tv = o - v0
        u = jnp.sum(tv * pv, axis=-1) * inv_det
        qv = jnp.cross(tv, e1)
        v = jnp.sum(d * qv, axis=-1) * inv_det
        t = jnp.sum(e2 * qv, axis=-1) * inv_det
        tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
        ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min)
              & (t <= tm[:, None]))
        tt = jnp.where(ok, t, jnp.inf)
        tb = tt.min(axis=1)
        n_s = len(slots)
        k = jnp.where(ok & (tt == tb[:, None]), jnp.arange(n_s), n_s).min(1)
        kc = jnp.minimum(k, n_s - 1)[:, None]
        upd = (k < n_s) & ((best_s < 0) | (tb < best_t))
        best_t = jnp.where(upd, tb, best_t)
        best_u = jnp.where(upd, jnp.take_along_axis(u, kc, 1)[:, 0], best_u)
        best_v = jnp.where(upd, jnp.take_along_axis(v, kc, 1)[:, 0], best_v)
        best_s = jnp.where(upd, jnp.asarray(slots, jnp.int32)[kc[:, 0]],
                           best_s)
        best_i = jnp.where(upd, inst, best_i)
    hit = best_s >= 0
    att = sw.attrs[:, :10][jnp.clip(best_s, 0, sw.attrs.shape[0] - 1)]
    w0 = (1.0 - best_u - best_v)[:, None]
    nrm = (w0 * att[:, 0:3] + best_u[:, None] * att[:, 3:6]
           + best_v[:, None] * att[:, 6:9])
    nrm = jnp.where(hit[:, None], nrm, 0.0)
    prim = jnp.where(hit, att[:, 9].astype(jnp.int32), -1)
    return JHitRecord(t=best_t, prim=prim, u=best_u, v=best_v, hit=hit,
                      inst=best_i), nrm


def _frame(metallic):
    """Inputs of one frame, built by the JAX package and carried to the
    port as numpy: scene BVHs, constants, materials, env and SH."""
    js = JScene(meshes=[j_ground_cube(), j_ground_cube()],
                materials=j_materials(),
                pos_scale=np.array([0, 3.0, 0, 1.0], np.float32))
    if metallic is not None:
        js.materials.rough_metals[:, 1] = metallic
    ts = Scene(meshes=[ground_cube(), ground_cube()],
               materials=Materials(js.materials.base_colors.copy(),
                                   js.materials.rough_metals.copy()),
               pos_scale=js.pos_scale)

    cam = JCamera(width=W, height=H)
    vp = cam.view_proj()
    worlds, prev = js.worlds(0.4), js.worlds(0.37)
    consts = jr.FrameConstants(
        world_view_projs=jnp.einsum("ijk,kl->ijl", worlds, vp),
        world_view_projs_prev=jnp.einsum("ijk,kl->ijl", prev, vp),
        worlds=worlds, world_its=js.normal_matrices(worlds),
        proj_to_world=jm3.inverse(vp), eye=jnp.asarray(cam.eye),
        proj_bias=jnp.asarray([0.013, -0.021], jnp.float32),
        frame_index=jnp.uint32(5),
        inv_worlds=jnp.stack([jm3.inverse(w) for w in worlds]))
    t = {k: torch.as_tensor(np.array(v)) for k, v in
         consts._asdict().items() if k != "frame_index"}
    t_consts = tr.FrameConstants(frame_index=5, **t)

    # the SAH scene build reads no LBVH, so none is built (its jit compile
    # costs tens of seconds); the TLAS reads each mesh's root box, the
    # bounds of its triangles' vertices
    jgeom = JGeometry(meshes=tuple(j_upload_mesh(m) for m in js.meshes),
                      blas=())
    j_sw = j_refit(j_build(jgeom, js.mesh_ids, leaf_size=64), worlds)
    t_geom = upload_scene(ts)
    t_sw = refit_scene_wide(build_scene_wide(t_geom, ts.mesh_ids,
                                             leaf_size=64), t["worlds"])
    env = j_env(16)
    s0 = int(env.sizes[0])
    sh = j_project_sh9(np.asarray(env.data[:6 * s0 * s0]).reshape(
        6, s0, s0, 3))
    jm = js.instance_materials()
    j_mats = jr.MaterialsDev(jnp.asarray(jm.base_colors),
                             jnp.asarray(jm.rough_metals))
    roots = [SimpleNamespace(aabb_min=m.triangles().min(axis=(0, 1))[None],
                             aabb_max=m.triangles().max(axis=(0, 1))[None])
             for m in js.meshes]
    ref = dict(tlas=j_build_tlas(roots, worlds, mesh_ids=js.mesh_ids),
               consts=consts, mats=j_mats, env=env, sh=sh, sw=j_sw)
    port = dict(tlas=build_tlas(t_geom.bounds, t["worlds"], ts.mesh_ids),
                consts=t_consts,
                mats=tr.MaterialsDev(torch.as_tensor(jm.base_colors),
                                     torch.as_tensor(jm.rough_metals)),
                env=from_reference_arrays(
                    *(np.asarray(x) for x in env[:3]), env.num_mips,
                    np.asarray(env.quad), np.asarray(env.tri)),
                sh=torch.as_tensor(np.array(sh)), sw=t_sw)
    return ref, port


def _ref_pass(ref):
    order, inv = j_order(W, H)
    sw = ref["sw"]
    return jr.ray_trace_pass(
        None, ref["tlas"], ref["consts"], ref["mats"], ref["env"], ref["sh"],
        W, H, trace_fused=lambda o, d, a, b: jax_bruteforce_fused(
            sw, o, d, a, b),
        ray_order=(jnp.asarray(order), jnp.asarray(inv)),
        sort_secondary=True, secondary_bucket=0.222)


def _port_pass(port):
    sw = port["sw"]
    return tr.ray_trace_pass(
        port["tlas"], port["consts"], port["mats"], port["env"], port["sh"],
        W, H, trace_fused=lambda o, d, a, b: trace_scene_wide_fused(
            sw, o, d, a, b),
        ray_order=make_block_order(W, H))


@pytest.mark.parametrize("metallic", [None, 0.5])
def test_ray_trace_pass_matches_reference(metallic):
    ref, port = _frame(metallic)
    want = {k: np.asarray(v) for k, v in _ref_pass(ref).items()}
    got = {k: v.numpy() for k, v in _port_pass(port).items()}
    hit = want["normal"][..., 3] > 0
    assert hit.any() and not hit.all()
    same = got["vis"] == want["vis"].astype(np.int64)
    assert same.mean() >= 0.99, f"vis agrees on {same.mean():.4f}"
    if metallic is not None:            # the diffuse wave ran
        assert np.abs(want["diff"][hit]).max() > 0
    for k in ("normal", "rough_metal", "depth", "velocity", "refl", "diff"):
        np.testing.assert_allclose(got[k][same], want[k][same], atol=1e-4,
                                   err_msg=k)
