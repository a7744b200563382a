"""The reference's instance walk: ``trace_scene`` walks only the (ray,
instance) pairs whose world box the ray enters, and gives bit for bit
what the sequential walk (one whole-wave walk per instance, in instance
order) gives: every hit record of a frame's waves, the frames and the
histories, at 2 and 8 instances and at about 300 small ones scattered in
no order, two of them overlapping exactly."""

import numpy as np
import pytest
import torch

import spec
from reference.frame import ReferenceRenderer
from reference.rt.trace import raygen, traverse
from standin import model_arrays

W, H, SUBDIV = 64, 36, 3
FOUR_K = spec.extra_instances(spec.load_json(
    spec.HERE / "configs" / "bunny-4k-8inst.json"))
# the model's own placement again: an instance that overlaps instance 1
# exactly, so that its every hit ties with one of instance 1
TWIN = (0.0, 1.0, 0.0, 1.0)


def scattered(n, seed, lo=0.2, hi=0.5, half=7.0):
    """n instances of the model at seeded places on the ground and seeded
    scales in [lo, hi), each sitting on the ground, in the order drawn."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(lo, hi, n)
    xz = rng.uniform(-half, half, (n, 2))
    return tuple((float(x), float(s), float(z), float(s))
                 for (x, z), s in zip(xz, scale))


LAYOUTS = {"2": (), "8": FOUR_K,
           "300": scattered(297, 300) + (TWIN,)}


def _reference(extra, metallic=0.5):
    return ReferenceRenderer(model_arrays(SUBDIV, (0.3, 1.1, 2.0)),
                             (0.0, 1.0, 0.0, 1.0), W, H,
                             metallic={0: metallic, 1: metallic},
                             extra_instances=extra)


def _frames(ref, n=2):
    st, out = ref.start_state(0.7, 37), []
    for _ in range(n):
        st, frame = ref.step(st, 1 / 60)
        out.append((frame, st.history))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_culled_walk_is_the_sequential_walk_bit_for_bit(monkeypatch,
                                                           layout):
    """Every wave of two frames at metallic 0.5 (primary, reflection and
    diffuse) walked both ways: the hit records agree field by field; the
    frames and histories the sequential walk renders are those of the
    culled walk."""
    extra = LAYOUTS[layout]
    culled = _frames(_reference(extra))
    records = []

    def both(*args):
        a = traverse.trace_scene(*args)
        b = traverse.trace_scene_sequential(*args)
        records.append((a, b))
        return b

    monkeypatch.setattr(raygen, "trace_scene", both)
    sequential = _frames(_reference(extra))
    assert len(records) == 6
    for a, b in records:
        for field in a._fields:
            assert torch.equal(getattr(a, field), getattr(b, field)), field
    for (f, h), (sf, sh) in zip(culled, sequential):
        assert torch.equal(f, sf) and torch.equal(h, sh)
    if TWIN in extra:
        # on every tie with instance 1 the lower index wins
        twin = 2 + extra.index(TWIN)
        inst = torch.cat([a.inst for a, _ in records])
        assert (inst == 1).any() and not (inst == twin).any()


def test_the_walk_launches_per_mesh_not_per_instance(monkeypatch):
    """At 300 instances the culled walk runs one wavefront per mesh a
    wave, where the sequential one runs one per instance."""
    walks = []
    real = traverse.trace_rays

    def counted(bvh, *args):
        walks.append(bvh.num_leaves)
        return real(bvh, *args)

    monkeypatch.setattr(traverse, "trace_rays", counted)
    ref = _reference(LAYOUTS["300"], metallic=1.0)
    _frames(ref, n=1)
    meshes = {g.tri.shape[0] for g in ref.geom.meshes}
    assert len(walks) <= 2 * len(meshes)          # two waves
    assert set(walks) <= meshes


def test_pairs_come_in_instance_order_and_cover_the_boxes_entered(
        monkeypatch):
    """instance_pairs keeps each pair whose world box the ray enters, in
    instance order and ray order within an instance; chunks of a few
    tests give the pairs one chunk gives."""
    from reference.rt.bvh import build_tlas
    from reference.rt.trace.intersect import ray_aabb, safe_inv_dir

    ref = _reference(LAYOUTS["300"])
    st = ref.start_state(0.7, 37)
    c = ref.constants(st.frame, st.angle, st.prev_wvp)
    tlas = build_tlas(ref.geom.bounds, c.worlds, ref.scene.mesh_ids,
                      inv_worlds=c.inv_worlds)
    _, p_near, d = raygen.primary_rays(c, W, H)
    t_min = traverse.per_ray(0.0, p_near)
    t_max = traverse.per_ray(raygen.T_MAX, p_near)
    rays, insts = traverse.instance_pairs(tlas, p_near, d, t_min, t_max)
    key = insts * p_near.shape[0] + rays
    assert torch.equal(key, torch.sort(key).values)
    assert len(set(key.tolist())) == key.shape[0]
    _, enter = ray_aabb(p_near[None], safe_inv_dir(d)[None],
                        tlas.aabb_min[:, None], tlas.aabb_max[:, None],
                        t_min[None], t_max[None])
    i, r = enter.nonzero(as_tuple=True)
    kept = set(key.tolist())
    assert set((i * p_near.shape[0] + r).tolist()) <= kept
    assert len(set(insts.tolist())) > 100
    monkeypatch.setattr(traverse, "BOX_TESTS", 1000)
    small = traverse.instance_pairs(tlas, p_near, d, t_min, t_max)
    assert torch.equal(small[0], rays) and torch.equal(small[1], insts)
