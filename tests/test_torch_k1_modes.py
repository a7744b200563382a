"""PyTorch port parity, K1's slim and fat modes.

The port's plain K1s (with its epilogue K1e's plain recompute of u, v) and
K1f, through ``trace_scene_wide_fused``, against the JAX package's
``trace_scene_wide_fused(slim=True)`` and its fat tree (``lean=False``),
the Pallas kernel in interpret mode, on one BVH carried across with
``from_reference_arrays``.  The bars of tests/test_scene_wide.py:66-96
(hit mask exact, t at rtol 1e-6, inst exact, u, v and the normal at atol
1e-4) hold each mode against the lean mode of the same implementation,
as there: one walk, so the same t.  Between the two implementations t is
held at the traversal bar of tests/test_scene_wide.py:56-63 (rtol 1e-4,
atol 1e-5), which test_torch_scene_wide.py uses for the lean mode: the
TPU kernel's reciprocal and either side's float32 order move t by up to
1.4e-5 relative on these rays; hit mask and inst exact, prim exact for
the fat mode (>= 99% for slim, whose lean walk may break an exact-t tie
on a shared edge otherwise), and u, v and the normal at atol 1e-4 where
prim agrees.  Then the three modes of the plain version against each
other, and kbench's ``k1_slim`` / ``k1_fat`` rows as a CPU rehearsal."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.ops.scene_wide import build_scene_wide as j_build
from raytracedggx_tpu.ops.scene_wide import refit_scene_wide as j_refit
from raytracedggx_tpu.ops.scene_wide import trace_scene_wide_fused as j_trace

from raytracedggx_tpu_torch.ops import fused
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   from_reference_arrays,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.trace.geometry import upload_scene
from test_torch_scene_wide import CASES, _rand_rays, _ref_geom, _scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _carried(js, angle, lean):
    """(reference tree refit at angle, the port's tree from its arrays)."""
    ref = j_refit(j_build(_ref_geom(js), js.mesh_ids, leaf_size=16,
                          lean=lean), js.worlds(angle))
    sw = from_reference_arrays(
        *(np.asarray(x) for x in (ref.nodes, ref.tris, ref.inv_mats)),
        None if ref.attrs is None else np.asarray(ref.attrs),
        leaf_size=ref.leaf_size, stack=ref.stack, n_top=ref.n_top,
        top_children=ref.top_children)
    return ref, sw


@pytest.mark.parametrize("extra,angle,mode", [
    (*CASES[1], "slim"), (*CASES[2], "slim"),
    (*CASES[2], "fat"),          # the fat interpret kernel is the slow one
])
def test_modes_match_reference_kernel(rng, extra, angle, mode):
    js, _ = _scenes(extra)
    ref_sw, sw = _carried(js, angle, lean=mode == "slim")
    assert sw.lean == (mode == "slim")
    o, d = _rand_rays(rng, 512)
    t_max = np.where(np.arange(512) % 4 == 3, -1.0, 1e4).astype(np.float32)
    ref, ref_n = j_trace(ref_sw, jnp.asarray(o), jnp.asarray(d), 0.0,
                         jnp.asarray(t_max), interpret=True,
                         slim=mode == "slim")
    got, got_n = trace_scene_wide_fused(sw, torch.as_tensor(o),
                                        torch.as_tensor(d), 0.0,
                                        torch.as_tensor(t_max),
                                        slim=mode == "slim")

    h = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    assert h.any() and not got.hit.numpy()[t_max < 0].any()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(ref.inst))
    same = got.prim.numpy() == np.asarray(ref.prim)
    if mode == "fat":
        assert same.all()
    else:
        assert same[h].mean() > 0.99
    k = h & same
    for a, b in ((got.u, ref.u), (got.v, ref.v), (got_n, ref_n)):
        np.testing.assert_allclose(a.numpy()[k], np.asarray(b)[k], atol=1e-4)

    # each mode against its own implementation's lean mode
    lean, lean_n = trace_scene_wide_fused(
        sw._replace(lean=True), torch.as_tensor(o), torch.as_tensor(d), 0.0,
        torch.as_tensor(t_max))
    np.testing.assert_array_equal(got.hit.numpy(), lean.hit.numpy())
    np.testing.assert_allclose(got.t.numpy()[h], lean.t.numpy()[h],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.inst.numpy()[h], lean.inst.numpy()[h])
    for a, b in ((got.u, lean.u), (got.v, lean.v), (got_n, lean_n)):
        np.testing.assert_allclose(a.numpy()[h], b.numpy()[h], atol=1e-4)


def test_fat_tree_carries_the_lean_trees_slots_and_attrs():
    """The reference's fat 19L leaf columns become the same (S, 9) slots
    and (S, 10) attrs as its lean tree's; only the fat tree carries the
    (S, 12) attrs4, attrs | 0 0."""
    js, _ = _scenes(CASES[2][0])
    _, lean = _carried(js, 1.3, lean=True)
    _, fat = _carried(js, 1.3, lean=False)
    assert lean.lean and not fat.lean
    for a, b in ((lean.tris, fat.tris), (lean.attrs, fat.attrs),
                 (lean.nodes, fat.nodes)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())   # NaN pads
    assert lean.attrs4 is None and fat.attrs4.is_contiguous()
    np.testing.assert_array_equal(fat.attrs4[:, :10].numpy(),
                                  lean.attrs.numpy())
    assert not fat.attrs4[:, 10:].any()


def test_plain_modes_agree_on_the_model():
    """The plain version's three modes on the stand-in model: one walk,
    so t, slot / prim and inst are lean's; K1e's plain recompute gives
    lean's u, v within float32 rounding; the fat normal is slot_normals of
    its own u, v; slim with a fat tree, and fat without attrs, raise."""
    from raytracedggx_tpu_torch.scripts.standin import model_scene

    scene = model_scene(3)
    sw = build_scene_wide(upload_scene(scene), scene.mesh_ids, leaf_size=8)
    sw = refit_scene_wide(sw, scene.worlds(0.6))
    rng = np.random.default_rng(4)
    o = rng.uniform(-3.0, 3.0, size=(512, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(1.5, 4.0, size=512)
    d = rng.uniform(-1.0, 1.0, size=(512, 3)).astype(np.float32) - o
    d[:, 1] += 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t_max = torch.where(torch.arange(512) % 5 == 4, -1.0, 1e4)
    args = (sw.tris, sw.inv_mats, sw.inst_slots, o, d, 1e-4, t_max)
    lean = fused.trace_instanced_plain(*args)
    slim = fused.trace_instanced_plain(*args, slim=True)
    fat = fused.trace_instanced_plain(*args, lean=False, attrs=sw.attrs)
    hit = lean[3] >= 0
    assert int((lean[4] == 1).sum()) > 50            # rays on the model
    for got in (slim, fat):
        assert torch.equal(got[0], lean[0]) and torch.equal(got[-1], lean[4])
    assert torch.equal(slim[1], lean[3])
    nrm, prim = fused.slot_normals(sw.attrs, lean[3], lean[1], lean[2])
    assert torch.equal(fat[1], lean[1]) and torch.equal(fat[2], lean[2])
    assert torch.equal(fat[4], prim) and torch.equal(fat[3], nrm)
    u, v = fused.slim_uv(sw.tris4, sw.inv_mats, o, d, slim[1], slim[2])
    torch.testing.assert_close(u[hit], lean[1][hit], rtol=0, atol=1e-5)
    torch.testing.assert_close(v[hit], lean[2][hit], rtol=0, atol=1e-5)
    assert not u[~hit].any() and not v[~hit].any()
    with pytest.raises(ValueError):
        trace_scene_wide_fused(sw._replace(lean=False), o, d, 0.0, t_max,
                               slim=True)
    with pytest.raises(ValueError):
        fused.trace_instanced_plain(*args, lean=False)
    with pytest.raises(ValueError):
        fused.trace_tiles_instanced(sw.nodes, sw.tris4, sw.inv_mats,
                                    sw.inst_slots, o, d, 0.0, t_max,
                                    sw.leaf_size, sw.k1_stack, slim=True,
                                    lean=False,
                                    attrs4=fused.attrs4_rows(sw.attrs))


def test_kbench_rehearses_the_k1_mode_rows():
    """kbench's k1_slim and k1_fat rows beside k1 on the CPU, in two
    interleaved rounds: each timed on both sets with t equal to K1's, then
    each row's median and its ratio to k1's."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KB_RES="64x36", KB_SUBDIV="3")
    res = subprocess.run(
        [sys.executable, "-m", "raytracedggx_tpu_torch.scripts.kbench", "1",
         "k1", "k1_slim", "k1_fat", "--device", "cpu", "--rounds", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    rows = [ln for ln in res.stdout.splitlines() if ln.startswith("k1")]
    names = ["k1", "k1_slim", "k1_fat"]
    assert [ln.split()[0] for ln in rows] == names * 3
    assert all("parity 0.00e+00" in ln for ln in rows[:6])
    assert all("median of 2 rounds" in ln for ln in rows[6:])
    assert "ratio to k1 1.0000 / 1.0000" in rows[6]
