"""Edge-aware separable spatial filters (reflection + diffuse).

Torch port of raytracedggx_tpu/denoise/spatial.py (CSSpatial_{H,V}_
{Refl,Diff}.hlsl, SpatialFilter.hlsli, FilterCommon.hlsli): radius 16,
filtering in the Reinhard luma tone-mapped domain.  Each H/V pass is
the plain torch stencil (ops/spatial_plain.py) whatever ``impl`` says.
The hit masking between the passes and the tone-map wrap stay here, as
in the reference.
"""

from __future__ import annotations

import torch

from ..ops.spatial_plain import diffuse_pass_plain, reflection_pass_plain

LUM_BASE = (0.25, 0.5, 0.25)


def _lum(rgb):
    return (rgb[..., 0] * LUM_BASE[0] + rgb[..., 1] * LUM_BASE[1]
            + rgb[..., 2] * LUM_BASE[2])


def tm(rgb):
    """Reinhard TM in luma (FilterCommon.hlsli:14-19)."""
    return rgb / (1.0 + _lum(rgb)[..., None])


def itm(rgb):
    """Inverse (FilterCommon.hlsli:24-27)."""
    return rgb / (1.0 - _lum(rgb)[..., None])


def reflection_spatial_filter(refl, normal, rough, depth, width, height,
                              impl: str = "cuda"):
    """H then V pass (Denoiser.cpp:361-409).  refl (H, W, 3) raw radiance;
    returns (H, W, 4): filtered rgb + hit-mask alpha where hit, the raw
    radiance with alpha 0 elsewhere."""
    rp = reflection_pass_plain
    hit = normal[..., 3] > 0.0
    h_out = rp(tm(refl).contiguous(), normal, rough, depth, width, height,
               axis=1)
    h_out = torch.where(hit[..., None], h_out, 0.0)
    v_out = rp(h_out, normal, rough, depth, width, height, axis=0)
    filtered = torch.cat([itm(v_out), torch.ones_like(v_out[..., :1])],
                         dim=-1)
    passthrough = torch.cat([refl, torch.zeros_like(refl[..., :1])], dim=-1)
    return torch.where(hit[..., None], filtered, passthrough)


def diffuse_spatial_filter(diff, filtered_refl, normal, metal, depth,
                           impl: str = "cuda"):
    """H then V diffuse pass, compositing the filtered reflection:
    out = filtered_refl.rgb + ITM(mu), alpha = filtered_refl.a
    (CSSpatial_V_Diff.hlsl:17-59); pixels failing the gate (hit and
    metallic < 1) pass filtered_refl through unchanged."""
    dp = diffuse_pass_plain
    gate = (normal[..., 3] > 0.0) & (metal < 1.0)
    h_out = dp(tm(diff).contiguous(), normal, metal, depth, axis=1)
    h_out = torch.where(gate[..., None], h_out, 0.0)
    v_out = dp(h_out, normal, metal, depth, axis=0)
    composite = torch.cat([filtered_refl[..., :3] + itm(v_out),
                           filtered_refl[..., 3:4]], dim=-1)
    return torch.where(gate[..., None], composite, filtered_refl)
