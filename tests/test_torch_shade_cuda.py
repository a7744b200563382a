"""The bounce waves' shading wrapper (``ops/shade_cuda.py``, BS) on the
CPU: for CPU tensors ``shade_bounce`` is the fused route's own expression
(the parent of the kernel: ``_shade_secondary`` with K1's normal, the
hit-or-miss ``where`` and the hit-flag ``cat``), bit for bit, on both
waves, at metallic 1, 0.5 and mixed, with misses and dead rays, over 2
and 8 instances, in the sorted, block and row-major orders; its input
checks refuse what the kernel cannot take; and K1's route calls it once
a bounce wave, the per-mesh routes never.  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import raytracedggx_tpu_torch.engine.renderer as t_renderer
import raytracedggx_tpu_torch.trace.raygen as raygen
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.ops import shade_cuda
from raytracedggx_tpu_torch.ops.ordering import sort_rays_morton
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.sh import evaluate_sh_irradiance
from raytracedggx_tpu_torch.trace.brdf import PI, env_brdf_approx
from raytracedggx_tpu_torch.trace.env import procedural_env, sample_env
from raytracedggx_tpu_torch.trace.shade import (get_base_color,
                                                get_rough_metal, get_uv)
from raytracedggx_tpu_torch.utils.math3d import reflect, saturate

W, H = 32, 18
# metallic of mesh 0 (the ground, instance 0: the checkerboard) and mesh 1
METALLIC = {"m1": (1.0, 1.0), "m05": (0.5, 0.5), "mixed": (0.5, 1.0)}
ORDERS = {"sorted": dict(), "block": dict(sort_secondary=False)}


def _scene(n_inst):
    extra = tuple((2.5 * (i % 3) - 2.5, 0.0, 2.5 * (i // 3) - 2.5, 0.6)
                  for i in range(n_inst - 2))
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32),
                 extra_instances=extra)


def _before(consts, mats, env, sh_coeffs, rec, nrm, o, d, damp):
    """The fused route's wave shading as it was written before the
    kernel (trace/raygen.py: ``_shade_secondary(..., fused_n=nrm,
    ray_o=o)`` with ``_spec_env_shade(..., miss_dir=d, hit=rec.hit)``,
    then ``where(hit, shaded, env_tap)`` and the hit flag's ``cat``)."""
    p_world = o + rec.t[..., None] * d
    pos_obj = raygen.world_to_object(consts, rec.inst, p_world)
    n = raygen._normalize(raygen.instance_xform(consts.world_its, rec.inst,
                                                nrm))
    v = -d
    uv = get_uv(nrm, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    a = rough * rough
    r = reflect(-v, n)
    k = ((1.0 - a) * (torch.sqrt(torch.clamp(1.0 - a, min=0.0)) + a))[..., None]
    sd = n + (r - n) * k
    nol = torch.sum(n * sd, dim=-1)
    nov = saturate(torch.sum(n * v, dim=-1))
    level = env.num_mips - 1.0 - (
        3.0 - 1.15 * torch.log2(torch.clamp(rough, min=1e-20)))
    tap_d = torch.where(rec.hit[..., None], sd, d)
    tap_l = torch.where(rec.hit, level, torch.zeros_like(rough))
    env_tap = rad = sample_env(env, tap_d, tap_l)
    rad = torch.where((nol > 0.0)[..., None], rad, 0.0)
    f0 = 0.04 * (1.0 - metal[..., None]) + color * metal[..., None]
    spec = rad * env_brdf_approx(f0, rough, nov)
    albedo = color * (1.0 - metal[..., None]) if damp else color
    diff = evaluate_sh_irradiance(sh_coeffs, n) / PI * albedo
    shaded = torch.where((metal > 0.5)[..., None], spec, diff)
    rad = torch.where(rec.hit[..., None], shaded, env_tap)
    return torch.cat([rad, rec.hit[..., None].to(rad.dtype)], dim=-1)


def _waves(monkeypatch, n_inst, metallic, order, frames=2):
    """[(args, out)] of every shade_bounce call over ``frames`` CPU
    frames of K1's route."""
    calls = []

    def spy(*args):
        out = shade_cuda.shade_bounce(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(raygen, "shade_bounce", spy)
    r = Renderer(_scene(n_inst), config=RenderConfig(width=W, height=H,
                                                     **ORDERS[order]),
                 device="cpu")
    for mesh_idx, m in enumerate(METALLIC[metallic]):
        r.set_metallic(mesh_idx, m)
    state = r.init_state()
    for _ in range(frames):
        state, _, _ = r.step(state, 1 / 30)
    return calls


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("metallic", list(METALLIC))
@pytest.mark.parametrize("n_inst", [2, 8])
def test_cpu_wrapper_is_the_fused_routes_expression(monkeypatch, n_inst,
                                                    metallic, order):
    """Every bounce wave of two frames: the wrapper's rows equal the
    expression the fused route computed before the kernel, bit for bit;
    every wave holds misses (dead rays among them), the reflection waves
    hits, the diffuse wave (damped) runs exactly where a metallic is below
    1, and no kernel launches."""
    n0 = shade_cuda.shade_bounce.launches
    calls = _waves(monkeypatch, n_inst, metallic, order)
    diffuse = min(METALLIC[metallic]) < 1.0
    assert [a[-1] for a, _ in calls] == ([False, True] * 2 if diffuse
                                         else [False] * 2)
    for args, out in calls:
        rec, o = args[4], args[6]
        assert out.shape == (o.shape[0], 4) and out.dtype == torch.float32
        assert torch.equal(_bits(out), _bits(_before(*args)))
        assert torch.equal(out[:, 3] > 0.5, rec.hit)
        assert bool((~rec.hit).any()) and bool((rec.inst == -1).any())
    assert all(bool(a[4].hit.any()) for a, _ in calls if not a[-1])
    assert shade_cuda.shade_bounce.launches == n0


@pytest.mark.parametrize("n_inst", [2, 8])
def test_shading_is_the_same_in_every_ray_order(monkeypatch, n_inst):
    """One ray a thread: a wave traced and shaded in row-major order
    (``ray_order`` None, as the unsorted path with no screen order runs
    it), in the bounce sort's order, or in a random order, gives the same
    rows back in original order, bit for bit, and the same hit flags."""
    args, _ = _waves(monkeypatch, n_inst, "m05", "sorted", frames=1)[1]
    consts, mats, env, sh_coeffs = args[:4]
    scene = _scene(n_inst)
    r = Renderer(scene, config=RenderConfig(width=W, height=H), device="cpu")
    sw = refit_scene_wide(build_scene_wide(r.geom, scene.mesh_ids),
                          consts.worlds)
    rng = np.random.default_rng(n_inst)
    n = 600
    o = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6.0, n)
    d = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t_max = torch.as_tensor(np.where(rng.random(n) < 0.8, 1e4, -1.0),
                            dtype=torch.float32)

    def trace(o, d, t_min, t_max):
        return trace_scene_wide_fused(sw, o, d, t_min, t_max)

    def shade(rec, nrm, o, d):
        return shade_cuda.shade_bounce(consts, mats, env, sh_coeffs, rec,
                                       nrm, o, d, False)
    perm = torch.as_tensor(rng.permutation(n))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n)
    lo, hi = sw.nodes.new_full((3,), -8.0), sw.nodes.new_full((3,), 8.0)
    orders = {"row-major": None, "random": (perm, inv),
              "bounce sort": sort_rays_morton(o, d, lo, hi,
                                              active=t_max > 0)}
    got = {k: raygen._trace_shade_ordered_fused(trace, shade, o, d, 1e-5,
                                                t_max, ro)
           for k, ro in orders.items()}
    rad0, hit0 = got["row-major"]
    assert bool(hit0.any()) and bool((~hit0).any())
    for rad, hit in got.values():
        assert torch.equal(_bits(rad), _bits(rad0)) and torch.equal(hit, hit0)


def _bad_inputs():
    """The wrapper's arguments as the reflection wave hands them over,
    each broken in one way (float32 tables, int64 ids, a bool hit flag, o
    and d views of the wave's (R, 7) bundle)."""
    n = 8
    consts = raygen.FrameConstants(
        world_view_projs=None, world_view_projs_prev=None, worlds=None,
        world_its=torch.eye(3).expand(2, 3, 3), proj_to_world=None,
        eye=None, proj_bias=None, frame_index=0,
        inv_worlds=torch.eye(4).expand(2, 4, 4))
    mats = raygen.MaterialsDev(base_colors=torch.ones((2, 4)),
                               rough_metals=torch.ones((2, 2)))
    env = procedural_env(4)
    rec = raygen.HitRecord(t=torch.ones(n), prim=torch.zeros(n,
                                                             dtype=torch.int64),
                           u=torch.zeros(n), v=torch.zeros(n),
                           hit=torch.ones(n, dtype=torch.bool),
                           inst=torch.zeros(n, dtype=torch.int64))
    bundle = torch.ones((n, 7))
    good = dict(consts=consts, mats=mats, env=env, sh=torch.ones((9, 3)),
                rec=rec, nrm=torch.ones((n, 3)), o=bundle[:, 0:3],
                d=bundle[:, 3:6])

    def bad(**kw):
        return {**good, **kw}
    many = shade_cuda.MAX_ROWS + 1
    return good, {
        "float64_t": bad(rec=rec._replace(t=rec.t.double())),
        "float16_normal": bad(nrm=good["nrm"].half()),
        "float64_direction": bad(d=good["d"].double()),
        "float_ids": bad(rec=rec._replace(inst=rec.inst.float())),
        "uint8_hit": bad(rec=rec._replace(hit=rec.hit.to(torch.uint8))),
        "float32_env": bad(env=env._replace(tri=env.tri.float())),
        "int32_mip_sizes": bad(env=env._replace(sizes=env.sizes.int())),
        "float64_sh": bad(sh=good["sh"].double()),
        "short_t": bad(rec=rec._replace(t=rec.t[:-1])),
        "short_ids": bad(rec=rec._replace(inst=rec.inst[1:])),
        "two_column_normal": bad(nrm=good["nrm"][:, :2]),
        "one_dim_origin": bad(o=good["o"][:, 0]),
        "sh_of_four_bands": bad(sh=torch.ones((16, 3))),
        "world_its_4x4": bad(consts=consts._replace(
            world_its=torch.eye(4).expand(2, 4, 4))),
        "no_instances": bad(mats=mats._replace(
            rough_metals=torch.ones((0, 2)))),
        "too_many_instances": bad(mats=mats._replace(
            base_colors=torch.ones((many, 4)))),
        "two_column_colors": bad(mats=mats._replace(
            base_colors=torch.ones((2, 2)))),
        "env_row_of_12": bad(env=env._replace(tri=env.tri[:, :12])),
        "strided_env": bad(env=env._replace(tri=env.tri[::2])),
        "normal_on_another_device": bad(nrm=good["nrm"].to("meta")),
        "env_on_another_device": bad(env=env._replace(
            tri=env.tri.to("meta"))),
        "table_on_another_device": bad(consts=consts._replace(
            inv_worlds=consts.inv_worlds.to("meta"))),
    }


def _call(kw):
    return shade_cuda._check(kw["consts"], kw["mats"], kw["env"], kw["sh"],
                             kw["rec"], kw["nrm"], kw["o"], kw["d"])


@pytest.mark.parametrize("case", list(_bad_inputs()[1]))
def test_kernel_checks_refuse_bad_inputs(case):
    """The checks a CUDA call runs before its launch refuse a dtype, shape
    or device the kernel cannot take."""
    with pytest.raises(ValueError):
        _call(_bad_inputs()[1][case])


def test_kernel_checks_pass_the_waves_inputs():
    """What a wave hands over passes, o and d strided views of its
    bundle, int32 or int64 ids: the checks give the number of rays."""
    good, _ = _bad_inputs()
    assert _call(good) == 8
    rec = good["rec"]
    assert _call({**good, "rec": rec._replace(inst=rec.inst.int())}) == 8


@pytest.mark.parametrize("traversal,calls", [
    ("wide", [False, False, True]), ("pallas4", []), ("pallas", []),
    ("jax", [])])
def test_k1_route_calls_the_wrapper_once_a_bounce_wave(monkeypatch,
                                                       traversal, calls):
    """BS is the K1 route's bounce-wave shading with no knob: one call a
    bounce wave (the reflection wave undamped, at metallic 0.5 the
    diffuse wave damped too), none on the per-mesh routes; its launch
    counter is the renderer's "BS" and counts no CPU call."""
    assert ("BS", shade_cuda.shade_bounce, "launches") in \
        t_renderer.launch_counters()
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return shade_cuda.shade_bounce(*args)
    monkeypatch.setattr(raygen, "shade_bounce", spy)
    r = Renderer(_scene(2), config=RenderConfig(width=W, height=H,
                                                traversal=traversal),
                 device="cpu")
    n0 = t_renderer.launch_counts()["BS"]
    state, _, _ = r.step(r.init_state(), 1 / 30)
    for mesh_idx in (0, 1):
        r.set_metallic(mesh_idx, 0.5)
    r.step(state, 1 / 30)
    assert seen == calls
    assert t_renderer.launch_counts()["BS"] == n0
