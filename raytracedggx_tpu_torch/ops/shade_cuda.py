"""A bounce wave's hit shading and miss tap: kernel BS and its plain
version.

``shade_bounce(consts, mats, env, sh_coeffs, rec, nrm, o, d,
damp_diffuse_albedo)`` shades one bounce wave of K1's route
(``traversal="wide"``) in the order K1 traced it: for each ray its
radiance (the hit shading where ``rec.hit``, else the env tap of its
direction at level 0) and its hit flag, as (R, 4) float32 rows that the
wave then un-permutes.  ``rec`` is K1's hit record (t, inst, hit), ``nrm``
its OBJECT-space interpolated normal, ``o`` / ``d`` the rays (any strides:
the wave hands over views of its sorted bundle).  The hit shading is
closestHitReflection / closestHitDiffuse at the recursion limit
(RayTracing.hlsl:570-614): the hit point on the ray, the material,
metallic > 0.5 takes the env-specular route, else SH diffuse with the
albedo damped by 1 - metallic on the diffuse wave
(``damp_diffuse_albedo``).

The plain version is the expression the fused route's wave used before
the kernel, moved here, bit for bit: whole-wave torch operations that
compute both routes and the env tap on every ray and select after.  It is
what runs for CPU tensors, so CPU frames keep their bits.  For CUDA
tensors the wrapper launches the CUDA kernel (``csrc/shade.cu``), which
computes one ray a thread only the branch the ray takes, bit for bit the
plain version on the card, or raises.  It ports no Pallas kernel: the JAX
package leaves the shading to XLA.  The per-mesh routes (``trace_fn``)
shade from the hit triangle's vertices and put in the miss radiance
themselves (``trace.raygen._shade_secondary``).
"""

from __future__ import annotations

import torch

from ..sh import evaluate_sh_irradiance
from ..trace.brdf import PI, env_brdf_approx
from ..trace.env import mip_level, sample_env
from ..trace.shade import get_base_color, get_rough_metal, get_uv
from ..utils.math3d import reflect, saturate
from .cuda_lib import check_launch, load_library, stream_handle
from .xform_cuda import instance_xform


def shade_bounce_plain(consts, mats, env, sh_coeffs, rec, nrm, o, d,
                       damp_diffuse_albedo):
    """The fused route's own expression for ``shade_bounce`` (module
    docstring), bit for bit."""
    hit = rec.hit
    p_world = o + rec.t[..., None] * d
    pos_obj = instance_xform(consts.inv_worlds, rec.inst, p_world,
                             affine=True)
    n = instance_xform(consts.world_its, rec.inst, nrm)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-20)
    v = -d
    uv = get_uv(nrm, pos_obj)
    rough, metal = get_rough_metal(mats.rough_metals, rec.inst, uv)
    color = get_base_color(mats.base_colors, rec.inst)[..., :3]
    # computeReflection at the recursion limit (RayTracing.hlsl:442-481):
    # the env tap serves double duty, hit lanes sample the roughness-
    # filtered spec direction, miss lanes their own direction at LOD 0
    a = rough * rough
    r = reflect(-v, n)
    k = ((1.0 - a) * (torch.sqrt(torch.clamp(1.0 - a, min=0.0)) + a))[..., None]
    spec_d = n + (r - n) * k                 # lerp(N, R, k), unnormalized
    nol = torch.sum(n * spec_d, dim=-1)
    nov = saturate(torch.sum(n * v, dim=-1))
    tap_d = torch.where(hit[..., None], spec_d, d)
    tap_l = torch.where(hit, mip_level(env, rough), torch.zeros_like(rough))
    env_tap = sample_env(env, tap_d, tap_l)
    rad = torch.where((nol > 0.0)[..., None], env_tap, 0.0)
    f0 = 0.04 * (1.0 - metal[..., None]) + color * metal[..., None]
    spec = rad * env_brdf_approx(f0, rough, nov)
    albedo = color * (1.0 - metal[..., None]) if damp_diffuse_albedo \
        else color
    diff = evaluate_sh_irradiance(sh_coeffs, n) / PI * albedo
    shaded = torch.where((metal > 0.5)[..., None], spec, diff)
    rad = torch.where(hit[..., None], shaded, env_tap)
    return torch.cat([rad, hit[..., None].to(rad.dtype)], dim=-1)


# the most rows of each per-instance table and the most env mips a block
# stages in shared memory (csrc/shade.cu's kMaxRows, kMaxMips)
MAX_ROWS, MAX_MIPS = 256, 16


def _check(consts, mats, env, sh_coeffs, rec, nrm, o, d):
    """Raise unless the inputs are what the kernel takes on one CUDA
    device; returns the number of rays."""
    dev = o.device
    f32 = {"inv_worlds": consts.inv_worlds, "world_its": consts.world_its,
           "rough_metals": mats.rough_metals,
           "base_colors": mats.base_colors, "sh_coeffs": sh_coeffs,
           "t": rec.t, "nrm": nrm, "o": o, "d": d}
    others = {"inst": rec.inst, "hit": rec.hit, "env.tri": env.tri,
              "env.sizes": env.sizes, "env.offsets": env.offsets}
    for name, x in {**f32, **others}.items():
        if x.device != dev:
            raise ValueError(f"shade_bounce: {name} on {x.device}, o on "
                             f"{dev}: need one device")
    for name, x in f32.items():
        if x.dtype != torch.float32:
            raise ValueError(f"shade_bounce: need float32 {name}, got "
                             f"{x.dtype}")
    want = {"inst": (torch.int32, torch.int64), "hit": (torch.bool,),
            "env.tri": (torch.float16,), "env.sizes": (torch.int64,),
            "env.offsets": (torch.int64,)}
    for name, dtypes in want.items():
        if others[name].dtype not in dtypes:
            raise ValueError(f"shade_bounce: {name} is "
                             f"{others[name].dtype}, need one of {dtypes}")
    n = o.shape[0] if o.dim() == 2 else -1
    shapes = {"o": (o, (n, 3)), "d": (d, (n, 3)), "nrm": (nrm, (n, 3)),
              "t": (rec.t, (n,)), "inst": (rec.inst, (n,)),
              "hit": (rec.hit, (n,)), "sh_coeffs": (sh_coeffs, (9, 3)),
              "env.tri": (env.tri, (env.tri.shape[0], 39)),
              "env.sizes": (env.sizes, (env.num_mips,)),
              "env.offsets": (env.offsets, (env.num_mips,))}
    tables = {"inv_worlds": (consts.inv_worlds, (4, 4)),
              "world_its": (consts.world_its, (3, 3)),
              "rough_metals": (mats.rough_metals, (2,)),
              "base_colors": (mats.base_colors, None)}
    for name, (x, tail) in tables.items():
        ok = x.dim() >= 2 and 1 <= x.shape[0] <= MAX_ROWS and (
            tuple(x.shape[1:]) == tail if tail else
            (x.dim() == 2 and x.shape[1] >= 3))
        if not ok:
            raise ValueError(f"shade_bounce: {name} {tuple(x.shape)}: need "
                             f"1 to {MAX_ROWS} rows of "
                             f"{tail or '>= 3 columns'}")
    for name, (x, shape) in shapes.items():
        if n < 0 or tuple(x.shape) != shape or x.dim() != len(shape):
            raise ValueError(f"shade_bounce: {name} {tuple(x.shape)}, "
                             f"need {shape} for o {tuple(o.shape)}")
    if not env.tri.is_contiguous() or not 1 <= env.num_mips <= MAX_MIPS:
        raise ValueError(f"shade_bounce: need a contiguous env.tri and 1 to "
                         f"{MAX_MIPS} mips, got {env.num_mips}")
    return n


def shade_bounce(consts, mats, env, sh_coeffs, rec, nrm, o, d,
                 damp_diffuse_albedo):
    """BS wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors.  Returns (R, 4) float32 rows: radiance | hit
    flag.  Launch counters count calls that launch the kernel: a frame
    captured into a CUDA graph (``Renderer.step_n``) counts once, at
    capture, not at each replay."""
    if o.device.type == "cpu":
        return shade_bounce_plain(consts, mats, env, sh_coeffs, rec, nrm, o,
                                  d, damp_diffuse_albedo)
    n = _check(consts, mats, env, sh_coeffs, rec, nrm, o, d)
    out = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    if n == 0:
        return out
    inv, wit = consts.inv_worlds, consts.world_its
    rm, bc = mats.rough_metals, mats.base_colors
    err = load_library().rtggx_shade_bounce(
        inv.data_ptr(), inv.shape[0], *inv.stride(),
        wit.data_ptr(), wit.shape[0], *wit.stride(),
        rm.data_ptr(), rm.shape[0], *rm.stride(),
        bc.data_ptr(), bc.shape[0], *bc.stride(),
        sh_coeffs.data_ptr(), *sh_coeffs.stride(),
        env.tri.data_ptr(), env.tri.shape[0], env.sizes.data_ptr(),
        env.offsets.data_ptr(), env.num_mips,
        o.data_ptr(), *o.stride(), d.data_ptr(), *d.stride(),
        rec.t.data_ptr(), rec.t.stride(0),
        rec.inst.data_ptr(), rec.inst.stride(0),
        int(rec.inst.dtype == torch.int64),
        rec.hit.data_ptr(), rec.hit.stride(0),
        nrm.data_ptr(), *nrm.stride(),
        int(bool(damp_diffuse_albedo)), n, out.data_ptr(),
        stream_handle(o.device))
    check_launch(err, "BS shade_bounce")
    shade_bounce.launches += 1
    return out


shade_bounce.launches = 0
