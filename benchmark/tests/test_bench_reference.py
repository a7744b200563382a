"""The plain reference against the port's CPU frame at a tiny size."""

import numpy as np
import pytest
import torch

from conftest import EXTRA
from harness import Draw, set_up, window
from reference.frame import ReferenceRenderer
from standin import model_arrays, write_obj

W, H, SUBDIV = 64, 36, 3


def _port(path, traversal, metallic, extra=()):
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.scene import Scene

    scene = Scene.create(str(path), pos_scale=(0.0, 1.0, 0.0, 1.0),
                         extra_instances=extra)
    r = Renderer(scene, config=RenderConfig(width=W, height=H,
                                            traversal=traversal),
                 device="cpu")
    for mesh in (0, 1):
        r.set_metallic(mesh, metallic)
    return r


def _frames(tmp_path, traversal, metallic, extra=(), n=3):
    arrays = model_arrays(SUBDIV, (0.3, 1.1, 2.0))
    path = tmp_path / "m.obj"
    write_obj(path, arrays)
    r = _port(path, traversal, metallic, extra)
    ref = ReferenceRenderer(arrays, (0.0, 1.0, 0.0, 1.0), W, H,
                            metallic={0: metallic, 1: metallic},
                            extra_instances=extra)
    st = r.init_state()._replace(angle=np.float32(0.7), frame=37)
    rs = ref.start_state(0.7, 37)
    out = []
    for _ in range(n):
        st, frame, _ = r.step(st, 1 / 60)
        rs, rframe = ref.step(rs, 1 / 60)
        out.append((frame, st.history, rframe, rs.history))
    return out


def test_standin_round_trips_through_the_ports_obj_loader(tmp_path):
    from raytracedggx_tpu_torch.scene import Scene

    pos, nrm, idx = model_arrays(SUBDIV, (0.5, 0.25, 4.0))
    write_obj(tmp_path / "m.obj", (pos, nrm, idx))
    mesh = Scene.create(str(tmp_path / "m.obj")).meshes[1]
    assert np.array_equal(mesh.positions, pos)
    assert np.array_equal(mesh.indices, idx)
    np.testing.assert_allclose(mesh.normals, nrm, atol=1e-7)


def test_seed_moves_phases_not_topology():
    a, b = Draw.of(1), Draw.of(2 ** 31 + 11)
    assert a != b and Draw.of(1) == a
    pa, _, ia = model_arrays(2, a.phases)
    pb, _, ib = model_arrays(2, b.phases)
    assert np.array_equal(ia, ib) and pa.shape == pb.shape
    assert not np.array_equal(pa, pb)


# metallic, extra instances; the 2-instance cases keep their ids
SCENES = [pytest.param(1.0, (), id="1.0"), pytest.param(0.5, (), id="0.5"),
          pytest.param(1.0, EXTRA, id="1.0-extra3"),
          pytest.param(0.5, EXTRA, id="0.5-extra3")]


@pytest.mark.parametrize("metallic,extra", SCENES)
def test_reference_is_the_ports_plain_route_bit_for_bit(tmp_path, metallic,
                                                       extra):
    """On the CPU the port's "jax" traversal runs the plain code the
    reference froze: frame and history agree bit for bit, with 3 extra
    instances of the model as with none."""
    for frame, hist, rframe, rhist in _frames(tmp_path, "jax", metallic,
                                              extra):
        assert torch.equal(frame, rframe)
        assert torch.equal(hist, rhist)


@pytest.mark.parametrize("metallic,extra", SCENES)
def test_reference_agrees_with_the_ports_main_path(tmp_path, metallic,
                                                  extra):
    """The port's "wide" frame (K1's plain twin on the CPU) differs from
    the reference only by the routes' arithmetic."""
    for frame, hist, rframe, rhist in _frames(tmp_path, "wide", metallic,
                                              extra):
        assert float((frame - rframe).abs().mean()) < 5e-4
        h, rh = hist.float(), rhist.float()
        assert float((h - rh).abs().sum() / rh.abs().sum()) < 1e-3


def test_every_extra_instance_shows_in_the_frame():
    """The layout the extra-instance tests use puts each instance where
    primary rays hit it, so that the comparisons above see all of them."""
    from reference.rt.bvh import build_tlas
    from reference.rt.trace.raygen import ray_trace_pass

    ref = ReferenceRenderer(model_arrays(SUBDIV, (0.3, 1.1, 2.0)),
                            (0.0, 1.0, 0.0, 1.0), W, H,
                            metallic={0: 1.0, 1: 1.0}, extra_instances=EXTRA)
    assert ref.scene.mesh_ids == (0, 1, 1, 1, 1)
    st = ref.start_state(0.7, 37)
    c = ref.constants(st.frame, st.angle, st.prev_wvp)
    tlas = build_tlas(ref.geom.bounds, c.worlds, ref.scene.mesh_ids,
                      inv_worlds=c.inv_worlds)
    vis = ray_trace_pass(tlas, c, ref.materials, ref.env, ref.sh_coeffs, W,
                         H, geom=ref.geom, trace_fn=ref.tracer,
                         diffuse=False)["vis"]
    shown = set(((vis[vis > 0] - 1) >> 24).tolist())
    assert shown == set(range(2 + len(EXTRA)))


def test_run_keeps_the_start_and_window_frames(tiny_cell):
    cell = tiny_cell()
    draw = Draw.of(5)
    dev = torch.device("cpu")
    r, state, prog, _ = set_up(cell.config, cell.traffic, draw, dev, 0.0)
    window(r, state, prog, cell.traffic, draw, 0.5, dev)
    assert [k.done for k in prog.kept[:2]] == [0, 1]
    assert prog.kept[-1].done == 1 + prog.frames
    assert all(k.before is not None for k in prog.kept[2:])
    assert len(prog.intervals_ms) == prog.frames


@pytest.mark.parametrize("tessellation,level", [("midpoint", 0),
                                                ("midpoint", 3),
                                                ("geodesic", 1),
                                                ("geodesic", 7),
                                                ("geodesic", 12)])
def test_the_standin_is_a_closed_outward_surface(tessellation, level):
    from standin import triangles

    pos, _, idx = model_arrays(level, (0.0, 0.0, 0.0), tessellation)
    f = idx.reshape(-1, 3).astype(np.int64)
    assert len(f) == triangles(tessellation, level)
    edges = {tuple(e) for e in np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                               f[:, [2, 0]]])}
    assert len(edges) == 3 * len(f)            # no directed edge twice
    assert all((b, a) in edges for a, b in edges)
    assert len(pos) - len(edges) // 2 + len(f) == 2      # a sphere
    v = pos[f].astype(np.float64)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ico = model_arrays(0, (0.0, 0.0, 0.0))
    fi = ico[2].reshape(-1, 3).astype(np.int64)
    vi = ico[0][fi].astype(np.float64)
    ni = np.cross(vi[:, 1] - vi[:, 0], vi[:, 2] - vi[:, 0])
    side = np.sign((ni * vi.mean(1)).sum(1))
    assert len(set(side)) == 1                 # the icosahedron's winding
    assert (np.sign((n * v.mean(1)).sum(1)) == side[0]).all()
