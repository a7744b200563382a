"""Order-3 spherical harmonics: env-probe projection + irradiance eval.

Torch port of raytracedggx_tpu/sh/sh9.py (XUSGAdvanced.h:623-647,
SHIrradianceTypeless.hlsli:16-37), with the reference's flipped basis
(x, y negated).  Coefficient order: [L00, L1-1, L10, L11, L2-2, L2-1,
L20, L21, L22].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)


SH_NUM_COEFF = 9


def _basis(d):
    """Real SH basis (order 3) in the reference's flipped frame
    (..., 3) -> (..., 9)."""
    x = -d[..., 0]
    y = -d[..., 1]
    z = d[..., 2]
    return torch.stack([
        0.28209479177 * torch.ones_like(x),
        0.48860251190 * y,
        0.48860251190 * z,
        0.48860251190 * x,
        1.09254843059 * x * y,
        1.09254843059 * y * z,
        0.31539156525 * (3.0 * z * z - 1.0),
        1.09254843059 * x * z,
        0.54627421529 * (x * x - y * y),
    ], dim=-1)


def _texel_solid_angles(size: int) -> np.ndarray:
    """Exact per-texel solid angle of a cube face (size, size)."""
    def area(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    e = (np.arange(size + 1) / size) * 2.0 - 1.0
    x0, y0 = np.meshgrid(e[:-1], e[:-1], indexing="xy")
    x1, y1 = np.meshgrid(e[1:], e[1:], indexing="xy")
    return (area(x1, y1) - area(x0, y1) - area(x1, y0) + area(x0, y0)
            ).astype(np.float32)


def project_sh9(faces):
    """Project a (6, S, S, 3) float32 cube map into (9, 3) SH radiance
    coefficients (one weighted reduction over all texels)."""
    from ..trace.env import face_uv_to_dir

    s = faces.shape[1]
    dev = faces.device
    w = torch.as_tensor(_texel_solid_angles(s), device=dev)
    uv = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    v, u = torch.meshgrid(uv, uv, indexing="ij")
    coeffs = torch.zeros((SH_NUM_COEFF, 3), dtype=torch.float32, device=dev)
    for f in range(6):
        b = _basis(face_uv_to_dir(f, u, v))             # (S, S, 9)
        wl = faces[f] * w[..., None]                    # (S, S, 3)
        coeffs = coeffs + torch.einsum("ijk,ijc->kc", b, wl)
    return coeffs


def evaluate_sh_irradiance(coeffs, n):
    """EvaluateSHIrradiance (SHIrradianceTypeless.hlsli:16-37).
    coeffs (9, 3); n (..., 3) unit normals -> (..., 3) irradiance."""
    c1 = 0.42904276540489171563379376569857
    c2 = 0.51166335397324424423977581244463
    c3 = 0.24770795610037568833406429782001
    c4 = 0.88622692545275801364908374167057

    x = -n[..., 0:1]
    y = -n[..., 1:2]
    z = n[..., 2:3]
    irr = ((c1 * (x * x - y * y)) * coeffs[8]
           + (c3 * (3.0 * z * z - 1.0)) * coeffs[6]
           + c4 * coeffs[0]
           + 2.0 * c1 * (coeffs[4] * x * y + coeffs[7] * x * z
                         + coeffs[5] * y * z)
           + 2.0 * c2 * (coeffs[3] * x + coeffs[1] * y + coeffs[2] * z))
    return torch.clamp(irr, min=0.0)
