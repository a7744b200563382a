"""The ray-trace dispatch: raygen + closest-hit + miss, as three waves.

Torch port of raytracedggx_tpu/trace/raygen.py (RayTracing.hlsl:540-625):
a primary wave (visibility buffer + G-buffers), a GGX reflection wave and
a cosine diffuse wave.  Two routes, as in the reference:

- ``trace_fused(o, d, t_min, t_max) -> (HitRecord, normal)`` (kernel K1,
  ``traversal="wide"``): the kernel interpolates the object-space normal,
  hit points lie on the ray, and each secondary wave is traced AND shaded
  in the sorted ray domain;
- ``trace_fn(tlas, o, d, t_min, t_max) -> HitRecord`` (the per-mesh
  traversals: K4, K5 or the plain wavefront ``trace_scene``): surface
  attributes come from the hit triangle's vertices
  (``trace.geometry.fetch_vertices``), and waves shade in row-major order.

``bary_mode="ndc"`` reconstructs the primary barycentrics from the
projected vertices (``calc_barycentrics``, RayTracing.hlsl:204-225); it
needs the vertices, so with ``trace_fused`` it traces through a
``trace_fn`` wrapper, as the reference does.

Dropped TPU workarounds that change no output:
- the static bucket prefix with its ``lax.cond`` overflow fallback
  (raygen.py:200-310): the kernels run over the whole sorted wave, and
  dead rays (t_max < 0) return at once;
- ``take_small``'s one-hot matmul is an index gather (trace/shade.py),
  and a per-ray product by a per-instance matrix is one kernel that
  never gathers the matrix (``ops.xform_cuda.instance_xform``, XF; on
  the CPU the gather and ``einsum`` it replaces);
- on K1's route a bounce wave's hit shading and miss tap are one kernel
  that computes, one ray a thread, only the branch the ray takes
  (``ops.shade_cuda.shade_bounce``, BS; on the CPU the whole-wave torch
  expression it replaces, which computes both and selects);
- the diffuse wave's runtime gate (``lax.cond`` on "any hit pixel with
  metallic < 1", raygen.py:769-777) is decided on the host from the
  materials (``diffuse``): a frame makes no host sync, so it can be
  captured into a CUDA graph.  The wave runs when any instance has
  metallic < 1; where no pixel passes the per-pixel gate it is an exact
  identity (hit pixels masked to 0, sky pixels env(-V), which the
  reflection wave already sampled; tests/test_torch_frame_loop.py).  The
  reference gates only the fused route; the port gates both.

``sort_dir_bits`` keeps the reference's name and default: 3 or 6
direction-class bits in the bounce sort key.  Not ported: the
reference's anchor key (each bounce ray's BVH-cut subtree id in the
key; on an H100 computing it cost more than it saved in K1) and its
profiling ablations of the reflection wave (the stage marks of
``engine.spans`` attribute the frame's time on the card).  Every miss
samples the env at LOD 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ordering import BlockOrder, sort_rays_morton
from ..ops.shade_cuda import shade_bounce
from ..ops.xform_cuda import instance_xform
from ..sh import evaluate_sh_irradiance
from ..utils.math3d import const, reflect, saturate
from .brdf import PI, env_brdf_approx, f_schlick, vis_smith
from .env import EnvMap, mip_level, sample_env
from .geometry import fetch_vertices, interp_attribs, interp_from_vertices
from .sampling import cos_dir, ggx_dir, sample_param
from .shade import get_base_color, get_rough_metal, get_uv, take_small
from .traverse import HitRecord, per_ray, trace_scene

PRIMITIVE_BITS = 24
T_MIN_SECONDARY = 1e-5
T_MAX = 10000.0


class FrameConstants(NamedTuple):
    """CBGlobal + RayGenConstants (RayTracing.hlsl:46-60), row-vector."""
    world_view_projs: torch.Tensor       # (I, 4, 4)
    world_view_projs_prev: torch.Tensor  # (I, 4, 4)
    worlds: torch.Tensor                 # (I, 4, 4)
    world_its: torch.Tensor              # (I, 3, 3)
    proj_to_world: torch.Tensor          # (4, 4) inverse(view @ proj)
    eye: torch.Tensor                    # (3,)
    proj_bias: torch.Tensor              # (2,) NDC jitter
    frame_index: int                     # mod 256
    inv_worlds: torch.Tensor             # (I, 4, 4)


class MaterialsDev(NamedTuple):
    base_colors: torch.Tensor   # (I, 4)
    rough_metals: torch.Tensor  # (I, 2)


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def _order_fns(ray_order):
    """(permute, unpermute) for a BlockOrder or (order, inverse)."""
    if isinstance(ray_order, BlockOrder):
        return ray_order.permute, ray_order.unpermute
    order, inv = ray_order
    return (lambda x: x[order]), (lambda x: x[inv])


def default_tracer(geom):
    """trace_fn over the per-mesh LBVHs with the plain wavefront traversal
    (``traversal="jax"``).  A per-ray t_max is applied after the trace,
    as the reference does."""
    def fn(tlas, o, d, t_min, t_max):
        per_ray = torch.is_tensor(t_max) and t_max.dim() != 0
        rec = trace_scene(geom.blas, geom.tri_data, tlas, o, d, t_min,
                          T_MAX if per_ray else t_max)
        if per_ray:
            dead = t_max < 0
            rec = rec._replace(hit=rec.hit & ~dead,
                               inst=torch.where(dead, -1, rec.inst))
        return rec
    return fn


def _trace_ordered(trace_fn, tlas, o, d, t_min, t_max, ray_order):
    """Trace with an optional ray permutation and return the HitRecord
    row-major."""
    if ray_order is None:
        return trace_fn(tlas, o, d, t_min, t_max)
    perm, unperm = _order_fns(ray_order)
    bundle = perm(torch.cat([o, d, per_ray(t_max, o)[:, None]], dim=-1))
    rec = trace_fn(tlas, bundle[:, 0:3], bundle[:, 3:6], t_min,
                   bundle[:, 6])
    fl = unperm(torch.stack([rec.t, rec.u, rec.v, rec.hit.to(rec.t.dtype)],
                            dim=-1))
    ints = unperm(torch.stack([rec.prim, rec.inst], dim=-1))
    return HitRecord(t=fl[:, 0], prim=ints[:, 0], u=fl[:, 1], v=fl[:, 2],
                     hit=fl[:, 3] > 0.5, inst=ints[:, 1])


def _trace_ordered_fused(trace_fused, o, d, t_min, t_max, ray_order):
    """Trace in ``ray_order`` and return (HitRecord, normal) row-major."""
    if ray_order is None:
        return trace_fused(o, d, t_min, t_max)
    perm, unperm = _order_fns(ray_order)
    bundle = perm(torch.cat([o, d, per_ray(t_max, o)[:, None]], dim=-1))
    rec, nrm = trace_fused(bundle[:, 0:3], bundle[:, 3:6], t_min,
                           bundle[:, 6])
    fl = unperm(torch.cat([torch.stack([rec.t, rec.u, rec.v], dim=-1), nrm],
                          dim=-1))
    ints = unperm(torch.stack([rec.prim, rec.inst], dim=-1))
    rec = type(rec)(t=fl[:, 0], prim=ints[:, 0], u=fl[:, 1], v=fl[:, 2],
                    hit=ints[:, 0] >= 0, inst=ints[:, 1])
    return rec, fl[:, 3:6]


def _trace_shade_ordered_fused(trace_fused, shade_fn, o, d, t_min, t_max,
                               ray_order):
    """Trace AND shade in the sorted ray domain (neighbouring rays tap
    neighbouring env texels), un-permuting only the radiance.
    shade_fn(rec, nrm, o, d) gives (R, 4) rows, radiance | hit flag, the
    miss radiance included (``ops.shade_cuda.shade_bounce``).  Returns
    (radiance (R, 3), secondary hit (R,)) in original ray order."""
    if ray_order is None:
        rec, nrm = trace_fused(o, d, t_min, t_max)
        out = shade_fn(rec, nrm, o, d)
    else:
        perm, unperm = _order_fns(ray_order)
        bundle = perm(torch.cat([o, d, per_ray(t_max, o)[:, None]], dim=-1))
        o_s, d_s = bundle[:, 0:3], bundle[:, 3:6]
        rec, nrm = trace_fused(o_s, d_s, t_min, bundle[:, 6])
        out = unperm(shade_fn(rec, nrm, o_s, d_s))
    return out[:, 0:3], out[:, 3] > 0.5


def world_to_object(consts: FrameConstants, inst, p_world):
    """Object-space position of world hit points through the per-instance
    inverse transforms (RayTracing.hlsl:236-244, 308-311)."""
    return instance_xform(consts.inv_worlds, inst, p_world, affine=True)


def _spec_env_shade(env: EnvMap, n, v, rough, color, metal):
    """computeReflection at the recursion limit (RayTracing.hlsl:442-481)."""
    a = rough * rough
    r = reflect(-v, n)
    k = ((1.0 - a) * (torch.sqrt(torch.clamp(1.0 - a, min=0.0)) + a))[..., None]
    d = n + (r - n) * k                      # lerp(N, R, k), unnormalized
    nol = torch.sum(n * d, dim=-1)
    nov = saturate(torch.sum(n * v, dim=-1))
    rad = sample_env(env, d, mip_level(env, rough))
    rad = torch.where((nol > 0.0)[..., None], rad, 0.0)
    f0 = 0.04 * (1.0 - metal[..., None]) + color * metal[..., None]
    return rad * env_brdf_approx(f0, rough, nov)


def _shade_secondary(consts, mats, env, sh_coeffs, rec, ray_dir,
                     damp_diffuse_albedo, geom, mesh_ids):
    """Closest-hit shading of depth-1 rays on the per-mesh routes
    (closestHitReflection / closestHitDiffuse, RayTracing.hlsl:570-614):
    the attributes come from the hit triangle's vertices (geom, mesh_ids);
    metallic > 0.5 takes the env-specular route, else SH diffuse (albedo
    damped by 1 - metallic on the diffuse wave).  K1's route shades with
    ``ops.shade_cuda.shade_bounce``."""
    pos_obj, nrm_obj = interp_attribs(geom, mesh_ids, rec.inst, rec.prim,
                                      rec.u, rec.v)
    n = _normalize(instance_xform(consts.world_its, rec.inst, nrm_obj))
    v = -ray_dir
    uv = get_uv(nrm_obj, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    spec = _spec_env_shade(env, n, v, rough, color, metal)
    albedo = color * (1.0 - metal[..., None]) if damp_diffuse_albedo \
        else color
    diff = evaluate_sh_irradiance(sh_coeffs, n) / PI * albedo
    return torch.where((metal > 0.5)[..., None], spec, diff)


def primary_rays(consts: FrameConstants, width: int, height: int,
                 row0: int = 0, band_height: int | None = None):
    """Jittered camera rays from the near plane (z_ndc = 0), so near-clip
    behaviour matches the raster pass.  Returns (ndc, p_near, ray_d).
    row0 / band_height: only image rows [row0, row0 + band_height) of the
    width x height viewport (a row band of the sharded renderer; rows
    outside the image are cast all the same)."""
    dev = consts.eye.device
    band_height = height if band_height is None else band_height
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    rows = torch.arange(band_height, dtype=torch.float32, device=dev)
    if row0:
        rows = rows + float(row0)
    ys = -((rows + 0.5) / height * 2.0 - 1.0)
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    ndc = torch.stack([sx.reshape(-1), sy.reshape(-1)], dim=-1)
    ndc = ndc - consts.proj_bias                                 # :300
    ndc_h = torch.cat([ndc, torch.zeros_like(ndc[..., :1]),
                       torch.ones_like(ndc[..., :1])], dim=-1)
    world = ndc_h @ consts.proj_to_world
    p_near = world[..., :3] / world[..., 3:4]
    return ndc, p_near, _normalize(p_near - consts.eye)


def calc_barycentrics(p, ndc):
    """calcBarycentrics (RayTracing.hlsl:204-225): perspective-correct
    barycentrics from clip-space triangle p (R, 3, 4) and pixel NDC
    (R, 2)."""
    inv_w = 1.0 / p[..., 3]                       # (R, 3)
    ndc_v = p[..., :2] * inv_w[..., None]         # (R, 3, 2)
    d21 = ndc_v[..., 2, :] - ndc_v[..., 1, :]
    d01 = ndc_v[..., 0, :] - ndc_v[..., 1, :]
    inv_det = 1.0 / (d21[..., 0] * d01[..., 1] - d21[..., 1] * d01[..., 0])
    dpdx = torch.stack([ndc_v[..., 1, 1] - ndc_v[..., 2, 1],
                        ndc_v[..., 2, 1] - ndc_v[..., 0, 1],
                        ndc_v[..., 0, 1] - ndc_v[..., 1, 1]],
                       dim=-1) * inv_det[..., None]
    dpdy = torch.stack([ndc_v[..., 2, 0] - ndc_v[..., 1, 0],
                        ndc_v[..., 0, 0] - ndc_v[..., 2, 0],
                        ndc_v[..., 1, 0] - ndc_v[..., 0, 0]],
                       dim=-1) * inv_det[..., None]
    delta = ndc - ndc_v[..., 0, :]
    interp_inv_w = (inv_w[..., 0]
                    + delta[..., 0] * torch.sum(inv_w * dpdx, dim=-1)
                    + delta[..., 1] * torch.sum(inv_w * dpdy, dim=-1))
    interp_w = 1.0 / interp_inv_w
    bx = interp_w * (delta[..., 0] * dpdx[..., 1] * inv_w[..., 1]
                     + delta[..., 1] * dpdy[..., 1] * inv_w[..., 1])
    by = interp_w * (delta[..., 0] * dpdx[..., 2] * inv_w[..., 2]
                     + delta[..., 1] * dpdy[..., 2] * inv_w[..., 2])
    return bx, by


def primary_surface(consts: FrameConstants, mats: MaterialsDev, width: int,
                    height: int, trace_fused=None, ray_order=None,
                    bary_mode: str = "direct", trace_fn=None, geom=None,
                    tlas=None, row0: int = 0, band_height: int | None = None):
    """Primary cast replacing the visibility raster + getPrimarySurface
    (RayTracing.hlsl:277-333).  Returns a dict of flat (R,) / (R, C)
    tensors.  row0 / band_height: ``primary_rays``."""
    ndc, p_near, ray_d = primary_rays(consts, width, height, row0,
                                      band_height)
    if trace_fused is not None and bary_mode == "direct":
        # K1 returns interpolated OBJECT-space normals; the hit point is
        # on the ray, its object position from the inverse world
        rec, nrm_obj = _trace_ordered_fused(trace_fused, p_near, ray_d, 0.0,
                                            T_MAX, ray_order)
        p_world = p_near + rec.t[..., None] * ray_d
        pos_obj = world_to_object(consts, rec.inst, p_world)
    else:
        if trace_fused is not None:     # ndc barycentrics need vertices
            def trace_fn(_tlas, o, d, a, b):
                return trace_fused(o, d, a, b)[0]
        rec = _trace_ordered(trace_fn, tlas, p_near, ray_d, 0.0, T_MAX,
                             ray_order)
        vp, vn = fetch_vertices(geom, tlas.mesh_ids, rec.inst, rec.prim)
        if bary_mode == "ndc":
            vh = torch.cat([vp, torch.ones_like(vp[..., :1])], dim=-1)
            clip_v = torch.einsum(
                "...vc,...cd->...vd", vh,
                take_small(consts.world_view_projs, rec.inst))
            u, v = calc_barycentrics(clip_v, ndc)
        else:
            u, v = rec.u, rec.v
        pos_obj, nrm_obj = interp_from_vertices(vp, vn, u, v)
        p_world = instance_xform(consts.worlds, rec.inst, pos_obj,
                                 affine=True)
    n = _normalize(instance_xform(consts.world_its, rec.inst, nrm_obj))

    uv = get_uv(nrm_obj, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    # sky pixels: P = near-plane point, N = 0, V toward eye (:319-331)
    hit3 = rec.hit[..., None]
    p_world = torch.where(hit3, p_world, p_near)
    n = torch.where(hit3, n, 0.0)
    v_dir = _normalize(consts.eye - p_world)

    # velocity (RayTracing.hlsl:308-311)
    prev_clip = instance_xform(consts.world_view_projs_prev, rec.inst,
                               pos_obj, affine=True, cols=4)
    velocity = ((ndc - prev_clip[..., :2] / prev_clip[..., 3:4])
                * const((0.5, -0.5), ndc))
    velocity = torch.where(hit3, velocity, 0.0)

    # raster-equivalent depth for the denoiser (z_clip / w of the hit)
    cur_clip = instance_xform(consts.world_view_projs, rec.inst, pos_obj,
                              affine=True, cols=4)
    depth = torch.where(rec.hit, cur_clip[..., 2] / cur_clip[..., 3], 1.0)

    # visibility ((inst << PRIMITIVE_BITS) | prim) + 1 (PSVisibility:18-24)
    vis = torch.where(rec.hit, ((rec.inst << PRIMITIVE_BITS) | rec.prim) + 1,
                      0)
    metal = torch.where(rec.hit, metal, 0.0)      # rghMtl.y = 0 for sky
    rough = torch.where(rec.hit, rough, 0.0)
    return dict(hit=rec.hit, vis=vis, n=n, v=v_dir, p=p_world, color=color,
                rough=rough, metal=metal, velocity=velocity, depth=depth)


def pixel_samples(width, height, frame_index, device, row0: int = 0):
    """(R, 2) per-pixel sample parameters of a frame (getSampleParam) for
    ``height`` rows from image row ``row0``: the RNG is keyed on global
    pixel ids, so a row band draws the full image's samples."""
    idx = torch.arange(width * height, device=device)
    py = idx // width
    if row0:
        py = py + row0
    return sample_param(idx % width, py, width, frame_index)


def reflection_rays(surf, xi):
    """The reflection wave's rays from the primary surface: GGX half
    vector h, N.L, direction (-V for sky pixels) and t_max (-1 = dead:
    sky pixels take env directly, N.L <= 0 pixels contribute 0)."""
    hit, n, v, rough = surf["hit"], surf["n"], surf["v"], surf["rough"]
    h = ggx_dir(rough * rough, n, xi)
    r_dir = reflect(-v, h)
    nol = torch.sum(n * r_dir, dim=-1)
    trace_dir = torch.where(hit[..., None], r_dir, -v)
    tmax_r = torch.where(hit & (nol > 0.0), T_MAX, -1.0)
    return h, nol, trace_dir, tmax_r


def ray_trace_pass(tlas, consts: FrameConstants, mats: MaterialsDev,
                   env: EnvMap, sh_coeffs, width: int, height: int,
                   trace_fused=None, ray_order=None,
                   bary_mode: str = "direct", trace_fn=None, geom=None,
                   sort_secondary: bool = True, sort_dir_bits: int = 3,
                   diffuse=None,
                   row0: int = 0, band_height: int | None = None,
                   mark=None):
    """Full DispatchRays equivalent.  Returns a dict of (H, W, C) images:
    refl, diff (radiance), normal (xyz*0.5+0.5 + hit alpha), rough_metal,
    velocity, depth, vis (int64).  row0 / band_height: only image rows
    [row0, row0 + band_height) of the width x height viewport, so H is
    band_height (the sharded renderer's bands; the RNG stays keyed on
    global pixel ids, so bands tile the full pass's rows).

    trace_fused (K1) or trace_fn(tlas, o, d, t_min, t_max) -> HitRecord;
    with neither, the plain wavefront traversal over geom's LBVHs.
    ray_order: screen-block order of the primary wave; sort_secondary:
    dead | direction class (sort_dir_bits) | Morton order for the bounce
    waves (else ray_order).
    diffuse: run the diffuse wave (the host's gate, module docstring);
    None decides it from ``mats.rough_metals``, a read of the device
    tensor (the renderer passes its own decision).  mark(stage) is called
    where the "primary", "reflection" and (when it runs) "diffuse" waves
    begin (``engine.spans.mark``); None marks nothing."""
    if bary_mode not in ("direct", "ndc"):
        raise NotImplementedError(f"bary_mode={bary_mode!r}")
    if mark is None:
        def mark(stage):
            pass
    if trace_fn is None and trace_fused is None:
        trace_fn = default_tracer(geom)
    band_height = height if band_height is None else band_height
    mark("primary")
    surf = primary_surface(consts, mats, width, height, trace_fused,
                           ray_order, bary_mode, trace_fn, geom, tlas,
                           row0, band_height)
    hit = surf["hit"]
    n, v, p = surf["n"], surf["v"], surf["p"]
    rough, metal, color = surf["rough"], surf["metal"], surf["color"]
    dev = n.device
    mark("reflection")

    xi = pixel_samples(width, band_height, consts.frame_index, dev, row0)
    lo = tlas.aabb_min.amin(dim=0)
    hi = tlas.aabb_max.amax(dim=0)

    def wave(dirs, tmax, damp_diffuse_albedo):
        """(radiance, secondary hit) of a bounce wave.  On the trace_fn
        route the radiance is the hit shading on every lane (the caller
        puts in the miss radiance)."""
        order = (sort_rays_morton(p, dirs, lo, hi, active=tmax > 0,
                                  dir_bits=sort_dir_bits)
                 if sort_secondary else ray_order)
        if trace_fused is not None:
            def shade(rec, nrm, o_s, d_s):
                return shade_bounce(consts, mats, env, sh_coeffs, rec, nrm,
                                    o_s, d_s, damp_diffuse_albedo)

            return _trace_shade_ordered_fused(trace_fused, shade, p, dirs,
                                              T_MIN_SECONDARY, tmax, order)
        rec = _trace_ordered(trace_fn, tlas, p, dirs, T_MIN_SECONDARY, tmax,
                             order)
        shaded = _shade_secondary(consts, mats, env, sh_coeffs, rec, dirs,
                                  damp_diffuse_albedo, geom, tlas.mesh_ids)
        return shaded, rec.hit

    # closestHitReflection early-out (:573): payload seeded with
    # color * metallic; an all-nonpositive seed skips hit shading
    seed = color * metal[..., None]
    seed_dead = torch.all(seed <= 0.0, dim=-1, keepdim=True)

    # ---------------- reflection wave (computeReflection, depth 0) -------
    h, nol, trace_dir, tmax_r = reflection_rays(surf, xi)
    radiance_r, hit_r = wave(trace_dir, tmax_r, False)
    if trace_fused is not None:
        radiance_r = torch.where(seed_dead & hit_r[..., None], seed,
                                 radiance_r)
        sky_env = radiance_r
    else:
        shaded_r = torch.where(seed_dead, seed, radiance_r)
        sky_env = sample_env(env, trace_dir, 0.0)
        radiance_r = torch.where(hit_r[..., None] & hit[..., None], shaded_r,
                                 sky_env)

    # primary BRDF weight (RayTracing.hlsl:461-478)
    f0 = 0.04 * (1.0 - metal[..., None]) + color * metal[..., None]
    voh = saturate(torch.sum(v * h, dim=-1))
    noh = saturate(torch.sum(n * h, dim=-1))
    nov = saturate(torch.sum(n * v, dim=-1))
    fres = f_schlick(f0, voh)
    vis_t = vis_smith(rough, nov, nol)
    weight = (nol * vis_t * (4.0 * voh / noh))[..., None] * fres
    refl = torch.where(hit[..., None],
                       torch.where((nol > 0.0)[..., None],
                                   radiance_r * weight, 0.0),
                       radiance_r)

    # ---------------- diffuse wave (computeDiffuse, depth 0) -------------
    # Gated on the host: with no instance below metallic 1 (the default
    # materials) no diffuse ray is live, every hit pixel's diff is masked
    # to 0 below, and a sky pixel's diff is env(-V), which the reflection
    # wave already sampled (its trace_dir is -V there and cannot hit).
    if diffuse is None:
        diffuse = bool((mats.rough_metals[:, 1] < 1.0).any())
    tmax_d = torch.where(hit & (metal < 1.0), T_MAX, -1.0)
    if diffuse:
        mark("diffuse")
        d_dir = cos_dir(n, xi)
        trace_dir_d = torch.where(hit[..., None], d_dir, -v)
        radiance_d, hit_d = wave(trace_dir_d, tmax_d, True)
        if trace_fused is None:
            radiance_d = torch.where(hit_d[..., None] & hit[..., None],
                                     radiance_d,
                                     sample_env(env, trace_dir_d, 0.0))
        # primary albedo weight: albedo * (1 - 0.04) at depth 0 (:532)
        diff = torch.where(hit[..., None], radiance_d * color * (1.0 - 0.04),
                           radiance_d)
    else:
        diff = torch.where(hit[..., None], 0.0, sky_env)
    # metallic >= 1 pixels never get a diffuse ray (raygenMain:559)
    diff = torch.where((metal < 1.0)[..., None], diff, 0.0)

    hw = (band_height, width)
    return dict(
        refl=refl.reshape(hw + (3,)),
        diff=diff.reshape(hw + (3,)),
        normal=torch.cat([n * 0.5 + 0.5, hit[..., None].to(n.dtype)],
                         dim=-1).reshape(hw + (4,)),
        rough_metal=torch.stack([rough, metal], dim=-1).reshape(hw + (2,)),
        velocity=surf["velocity"].reshape(hw + (2,)),
        depth=surf["depth"].reshape(hw),
        vis=surf["vis"].reshape(hw),
    )
