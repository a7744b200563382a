"""The ray-trace dispatch: raygen + closest-hit + miss, as three waves.

A frozen copy of the port's plain route (its ``traversal="jax"``), cut to
what the benchmark's reference runs (RayTracing.hlsl:540-625): a primary
wave (visibility buffer + G-buffers), a GGX reflection wave and a cosine
diffuse wave, each traced by the plain wavefront walk of each mesh's own
LBVH (``default_tracer``) in row-major order; surface attributes come
from the hit triangle's vertices (``trace.geometry.fetch_vertices``).

The diffuse wave's gate (any instance below metallic 1) is decided on the
host from the materials (``diffuse``).  Where no pixel passes the
per-pixel gate the wave is an exact identity: hit pixels masked to 0, sky
pixels env(-V), which the reflection wave already sampled.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sh import evaluate_sh_irradiance
from ..utils.math3d import const, reflect, saturate
from .brdf import PI, env_brdf_approx, f_schlick, vis_smith
from .env import EnvMap, sample_env
from .geometry import fetch_vertices, interp_attribs, interp_from_vertices
from .sampling import cos_dir, ggx_dir, sample_param
from .shade import get_base_color, get_rough_metal, get_uv, take_small
from .traverse import trace_scene

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


def _mip_level(env: EnvMap, rough):
    """calcCubemapMipFromRoughness (RayTracing.hlsl:416-422)."""
    level = 3.0 - 1.15 * torch.log2(torch.clamp(rough, min=1e-20))
    return env.num_mips - 1.0 - level


def _spec_env_shade(env: EnvMap, n, v, rough, color, metal):
    """computeReflection at the recursion limit (RayTracing.hlsl:442-481):
    the env sampled along the roughness-filtered spec direction."""
    a = rough * rough
    r = reflect(-v, n)
    k = ((1.0 - a) * (torch.sqrt(torch.clamp(1.0 - a, min=0.0)) + a))[..., None]
    d = n + (r - n) * k                      # lerp(N, R, k), unnormalized
    nol = torch.sum(n * d, dim=-1)
    nov = saturate(torch.sum(n * v, dim=-1))
    rad = sample_env(env, d, _mip_level(env, rough))
    rad = torch.where((nol > 0.0)[..., None], rad, 0.0)
    f0 = 0.04 * (1.0 - metal[..., None]) + color * metal[..., None]
    return rad * env_brdf_approx(f0, rough, nov)


def _shade_secondary(consts, mats, env, sh_coeffs, rec, ray_dir,
                     damp_diffuse_albedo, geom, mesh_ids):
    """Closest-hit shading of depth-1 rays (closestHitReflection /
    closestHitDiffuse, RayTracing.hlsl:570-614): metallic > 0.5 takes the
    env-specular route, else SH diffuse (albedo damped by 1 - metallic on
    the diffuse wave); the attributes from the hit triangle's vertices."""
    pos_obj, nrm_obj = interp_attribs(geom, mesh_ids, rec.inst, rec.prim,
                                      rec.u, rec.v)
    n = _normalize(torch.einsum("...c,...cd->...d", nrm_obj,
                                take_small(consts.world_its, rec.inst)))
    v = -ray_dir
    uv = get_uv(nrm_obj, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    spec = _spec_env_shade(env, n, v, rough, color, metal)
    albedo = color * (1.0 - metal[..., None]) if damp_diffuse_albedo \
        else color
    diff = evaluate_sh_irradiance(sh_coeffs, n) / PI * albedo
    return torch.where((metal > 0.5)[..., None], spec, diff)


def primary_rays(consts: FrameConstants, width: int, height: int):
    """Jittered camera rays from the near plane (z_ndc = 0), so near-clip
    behaviour matches the raster pass.  Returns (ndc, p_near, ray_d)."""
    dev = consts.eye.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    rows = torch.arange(height, dtype=torch.float32, device=dev)
    ys = -((rows + 0.5) / height * 2.0 - 1.0)
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    ndc = torch.stack([sx.reshape(-1), sy.reshape(-1)], dim=-1)
    ndc = ndc - consts.proj_bias                                 # :300
    ndc_h = torch.cat([ndc, torch.zeros_like(ndc[..., :1]),
                       torch.ones_like(ndc[..., :1])], dim=-1)
    world = ndc_h @ consts.proj_to_world
    p_near = world[..., :3] / world[..., 3:4]
    return ndc, p_near, _normalize(p_near - consts.eye)


def primary_surface(consts: FrameConstants, mats: MaterialsDev, width: int,
                    height: int, trace_fn, geom, tlas):
    """Primary cast replacing the visibility raster + getPrimarySurface
    (RayTracing.hlsl:277-333).  Returns a dict of flat (R,) / (R, C)
    tensors."""
    ndc, p_near, ray_d = primary_rays(consts, width, height)
    rec = trace_fn(tlas, p_near, ray_d, 0.0, T_MAX)
    vp, vn = fetch_vertices(geom, tlas.mesh_ids, rec.inst, rec.prim)
    pos_obj, nrm_obj = interp_from_vertices(vp, vn, rec.u, rec.v)
    worlds = take_small(consts.worlds, rec.inst)
    p_world = (torch.einsum("...c,...cd->...d", pos_obj,
                            worlds[..., :3, :3]) + worlds[..., 3, :3])
    n = _normalize(torch.einsum("...c,...cd->...d", nrm_obj,
                                take_small(consts.world_its, rec.inst)))

    uv = get_uv(nrm_obj, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    # sky pixels: P = near-plane point, N = 0, V toward eye (:319-331)
    hit3 = rec.hit[..., None]
    p_world = torch.where(hit3, p_world, p_near)
    n = torch.where(hit3, n, 0.0)
    v_dir = _normalize(consts.eye - p_world)

    # velocity (RayTracing.hlsl:308-311)
    pos_h = torch.cat([pos_obj, torch.ones_like(pos_obj[..., :1])], dim=-1)
    prev_clip = torch.einsum("...c,...cd->...d", pos_h,
                             take_small(consts.world_view_projs_prev,
                                        rec.inst))
    velocity = ((ndc - prev_clip[..., :2] / prev_clip[..., 3:4])
                * const((0.5, -0.5), ndc))
    velocity = torch.where(hit3, velocity, 0.0)

    # raster-equivalent depth for the denoiser (z_clip / w of the hit)
    cur_clip = torch.einsum("...c,...cd->...d", pos_h,
                            take_small(consts.world_view_projs, rec.inst))
    depth = torch.where(rec.hit, cur_clip[..., 2] / cur_clip[..., 3], 1.0)

    # visibility ((inst << PRIMITIVE_BITS) | prim) + 1 (PSVisibility:18-24)
    vis = torch.where(rec.hit, ((rec.inst << PRIMITIVE_BITS) | rec.prim) + 1,
                      0)
    metal = torch.where(rec.hit, metal, 0.0)      # rghMtl.y = 0 for sky
    rough = torch.where(rec.hit, rough, 0.0)
    return dict(hit=rec.hit, vis=vis, n=n, v=v_dir, p=p_world, color=color,
                rough=rough, metal=metal, velocity=velocity, depth=depth)


def pixel_samples(width, height, frame_index, device):
    """(R, 2) per-pixel sample parameters of a frame (getSampleParam)."""
    idx = torch.arange(width * height, device=device)
    return sample_param(idx % width, idx // width, width, frame_index)


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
                   env: EnvMap, sh_coeffs, width: int, height: int, geom,
                   trace_fn, diffuse: bool):
    """Full DispatchRays equivalent.  Returns a dict of (H, W, C) images:
    refl, diff (radiance), normal (xyz*0.5+0.5 + hit alpha), rough_metal,
    velocity, depth, vis (int64).  trace_fn(tlas, o, d, t_min, t_max) ->
    HitRecord (``default_tracer``); diffuse: run the diffuse wave (the
    host's gate, module docstring)."""
    surf = primary_surface(consts, mats, width, height, trace_fn, geom, tlas)
    hit = surf["hit"]
    n, v, p = surf["n"], surf["v"], surf["p"]
    rough, metal, color = surf["rough"], surf["metal"], surf["color"]
    xi = pixel_samples(width, height, consts.frame_index, n.device)

    def wave(dirs, tmax, damp_diffuse_albedo):
        """(hit shading on every lane, secondary hit) of a bounce wave;
        the caller puts in the miss radiance."""
        rec = trace_fn(tlas, p, dirs, T_MIN_SECONDARY, tmax)
        return _shade_secondary(consts, mats, env, sh_coeffs, rec, dirs,
                                damp_diffuse_albedo, geom,
                                tlas.mesh_ids), rec.hit

    # closestHitReflection early-out (:573): payload seeded with
    # color * metallic; an all-nonpositive seed skips hit shading
    seed = color * metal[..., None]
    seed_dead = torch.all(seed <= 0.0, dim=-1, keepdim=True)

    # ---------------- reflection wave (computeReflection, depth 0) -------
    h, nol, trace_dir, tmax_r = reflection_rays(surf, xi)
    radiance_r, hit_r = wave(trace_dir, tmax_r, False)
    shaded_r = torch.where(seed_dead, seed, radiance_r)
    env_r = sample_env(env, trace_dir, 0.0)
    radiance_r = torch.where(hit_r[..., None] & hit[..., None], shaded_r,
                             env_r)

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
    # Gated on the host: with no instance below metallic 1 no diffuse ray
    # is live, every hit pixel's diff is masked to 0 below, and a sky
    # pixel's diff is env(-V), which the reflection wave already sampled
    # (its trace_dir is -V there and cannot hit).
    tmax_d = torch.where(hit & (metal < 1.0), T_MAX, -1.0)
    if diffuse:
        d_dir = cos_dir(n, xi)
        trace_dir_d = torch.where(hit[..., None], d_dir, -v)
        radiance_d, hit_d = wave(trace_dir_d, tmax_d, True)
        radiance_d = torch.where(hit_d[..., None] & hit[..., None],
                                 radiance_d,
                                 sample_env(env, trace_dir_d, 0.0))
        # primary albedo weight: albedo * (1 - 0.04) at depth 0 (:532)
        diff = torch.where(hit[..., None], radiance_d * color * (1.0 - 0.04),
                           radiance_d)
    else:
        diff = torch.where(hit[..., None], 0.0, env_r)
    # metallic >= 1 pixels never get a diffuse ray (raygenMain:559)
    diff = torch.where((metal < 1.0)[..., None], diff, 0.0)

    hw = (height, width)
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
