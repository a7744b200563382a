"""GGX BRDF terms (BRDFModels.hlsli:1-77).

Torch port of raytracedggx_tpu/trace/brdf.py, cut to the terms the frame
uses: F_Schlick, Vis_Smith and EnvBRDFApprox.
"""

from __future__ import annotations

import math

import torch

from ..utils.math3d import const

PI = math.pi


def vis_smith(roughness, nov, nol):
    a = roughness * roughness
    a2 = a * a
    vv = nov + torch.sqrt(nov * (nov - nov * a2) + a2)
    vl = nol + torch.sqrt(nol * (nol - nol * a2) + a2)
    return 1.0 / (vv * vl)


def f_schlick(f0, voh):
    """F_Schlick with <2% reflectance treated as shadowing
    (BRDFModels.hlsli:54-62); f0 (..., 3), voh (...,)."""
    fc = (1.0 - voh) ** 5.0
    shadow = torch.clamp(50.0 * f0[..., 1], 0.0, 1.0)
    return (shadow * fc)[..., None] + (1.0 - fc)[..., None] * f0


def env_brdf_approx(f0, roughness, nov):
    """EnvBRDFApprox (BRDFModels.hlsli:64-77)."""
    c0 = const((-1.0, -0.0275, -0.572, 0.022), f0)
    c1 = const((1.0, 0.0425, 1.04, -0.04), f0)
    r = roughness[..., None] * c0 + c1
    a004 = (torch.minimum(r[..., 0] * r[..., 0], torch.exp2(-9.28 * nov))
            * r[..., 0] + r[..., 1])
    ab_x = -1.04 * a004 + r[..., 2]
    ab_y = 1.04 * a004 + r[..., 3]
    ab_y = ab_y * torch.clamp(50.0 * f0[..., 1], 0.0, 1.0)
    return f0 * ab_x[..., None] + ab_y[..., None]
