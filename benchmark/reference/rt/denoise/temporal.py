"""Temporal supersampling (TAA-style accumulate) — CSTemporalSS.hlsl.

Torch port of raytracedggx_tpu/denoise/temporal.py: velocity dilation,
bilinear-clamp history resample, YCoCg variance AABB with adaptive gamma,
anti-alias blend, convergence counter in alpha.  The reference resamples
with a windowed tent stencil under a ``lax.cond`` (both branches compute
the same bilinear sample; the stencil avoids TPU gathers); the port uses
the gather form, ``_bilinear_clamp_pix``.  Out-of-bounds neighbour loads
are zeros (HLSL OOB).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.math3d import const

HISTORY_BITS = 4
HISTORY_MAX = float((1 << HISTORY_BITS) - 1)

_DIAG = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
_CROSS = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_OFFSETS = _CROSS + _DIAG          # g_texOffsets order (:45-49)
_WEIGHTS = [0.5] * 4 + [0.25] * 4  # NeighborMinMax weights (:175-179)


def _shift(img, dy, dx):
    """out[y, x] = img[y - dy, x - dx], zeros outside (H, W, ...)."""
    h, w = img.shape[0], img.shape[1]
    pad = [0, 0] * (img.dim() - 2) + [max(dx, 0), max(-dx, 0),
                                      max(dy, 0), max(-dy, 0)]
    p = F.pad(img, pad)
    return p[max(-dy, 0):max(-dy, 0) + h, max(-dx, 0):max(-dx, 0) + w]


def rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([r + 2 * g + b, 2 * r - 2 * b, -r + 2 * g - b],
                       dim=-1)


def ycocg_to_rgb(c):
    y, co, cg = c[..., 0] * 0.25, c[..., 1] * 0.25, c[..., 2] * 0.25
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _tm(rgb):
    c = rgb_to_ycocg(rgb)
    return c / (4.0 + c[..., 0:1])


def _itm(c):
    return ycocg_to_rgb(c * (4.0 / (1.0 - c[..., 0:1])))


def _bilinear_clamp_pix(img, x, y):
    """Bilinear sample (H, W, C) at continuous pixel coords, clamped to
    the image (one gather of each pixel's packed 2x2 footprint)."""
    h, w, c = img.shape
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, float(h - 1))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    row0 = torch.cat([img, right], dim=-1)                 # [c00 | c10]
    quad = torch.cat([row0, torch.cat([row0[1:], row0[-1:]], dim=0)],
                     dim=-1)                               # + [c01 | c11]
    iy = y0.to(torch.int64)
    idx = (iy * w + x0.to(torch.int64)).reshape(-1)
    q = quad.reshape(h * w, 4 * c)[idx].reshape(*x.shape, 4 * c)
    return (q[..., 0:c] * (1 - fx) * (1 - fy)
            + q[..., c:2 * c] * fx * (1 - fy)
            + q[..., 2 * c:3 * c] * (1 - fx) * fy
            + q[..., 3 * c:] * fx * fy)


def _velocity_max(velocity):
    """VelocityMax (:139-167): center + 4 diagonals, strictly-greater
    speed comparison in sequence."""
    best = velocity
    best_sq = torch.sum(best * best, dim=-1)
    for dy, dx in _DIAG:
        nb = _shift(velocity, dy, dx)
        sq = torch.sum(nb * nb, dim=-1)
        best = torch.where((sq > best_sq)[..., None], nb, best)
        best_sq = torch.maximum(sq, best_sq)
    return best


def temporal_ss(current, history, velocity):
    """current/history (H, W, 4), velocity (H, W, 2) in fractions of the
    viewport (NDC*0.5 units).  Returns the new accumulation (H, W, 4) float32; callers store it at
    their history dtype (f16, the reference's RGBA16F TemporalSSOut)."""
    history = history.to(torch.float32)
    h, w = current.shape[0], current.shape[1]
    dev = current.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")

    vel = _velocity_max(velocity)
    # history resample at uv - velocity, coordinate clamped first
    qx = torch.clamp(xs - vel[..., 0] * w, 0.0, w - 1.0)
    qy = torch.clamp(ys - vel[..., 1] * h, 0.0, h - 1.0)
    hist = _bilinear_clamp_pix(history, qx, qy)

    # speed -> blur estimate (:276-283)
    blurs = torch.abs(vel) * const((4.0 * w, 4.0 * h), vel)
    cur_history_blur = blurs[..., 0] + blurs[..., 1]
    history_blur = torch.maximum(1.0 - hist[..., 3], cur_history_blur)
    hist_count = hist[..., 3] * HISTORY_MAX + 1.0

    cur_rgb = current[..., :3]
    cur_a = current[..., 3]
    cur_tm = _tm(cur_rgb)

    # gamma (:291): _DENOISE_ branch
    gamma = torch.where(cur_a <= 0.0, 1.0,
                        torch.clamp(8.0 / torch.clamp(history_blur, min=1e-6),
                                    1.0, 32.0))

    # ---- NeighborMinMax (:173-252) -----------------------------------
    filt = torch.cat([cur_tm, cur_a[..., None]], dim=-1)
    m1 = cur_tm
    m2 = cur_tm * cur_tm
    for (dy, dx), wgt in zip(_OFFSETS, _WEIGHTS):
        nb = _shift(current, dy, dx)
        nb_tm = _tm(nb[..., :3])
        filt = filt + torch.cat([nb_tm, nb[..., 3:4]], dim=-1) * wgt
        m1 = m1 + nb_tm
        m2 = m2 + nb_tm * nb_tm
    filt = filt / 4.0

    # _DENOISE_ + _ALPHA_AS_ID_ gamma relaxation (:201-205)
    gamma = torch.where(torch.abs(cur_a - filt[..., 3]) < 1.0 / 255.0,
                        gamma, 1.0)

    ns = float(len(_OFFSETS) + 1)
    mu = m1 / ns
    sigma = torch.sqrt(torch.abs(m2 / ns - mu * mu))
    nmin = torch.minimum(mu - gamma[..., None] * sigma, filt[..., :3])
    nmax = torch.maximum(mu + gamma[..., None] * sigma, filt[..., :3])
    nmin_w = (mu - sigma)[..., 0]
    nmax_w = (mu + sigma)[..., 0]

    cur_history_blur = torch.clamp(cur_history_blur, 0.0, 1.0)
    history_blur = torch.clamp(history_blur, 0.0, 1.0)

    # clamp history in YCoCg (:306-311)
    hist_tm = torch.minimum(torch.maximum(_tm(hist[..., :3]), nmin), nmax)
    contrast = nmax_w - nmin_w

    # anti-alias add-back (:313-322); YCoCg luma contrast factor 32*4
    add_alias = history_blur * 0.5 + 0.25
    add_alias = torch.clamp(add_alias + 1.0 / (1.0 + contrast * 128.0),
                            0.0, 1.0)
    filt_rgb = filt[..., :3] + (cur_tm - filt[..., :3]) * add_alias[..., None]

    # blend factor (:324-334)
    lum_hist = hist_tm[..., 0]
    dist_to_clamp = torch.minimum(torch.abs(nmin_w - lum_hist),
                                  torch.abs(nmax_w - lum_hist))
    history_amt = torch.clamp(1.0 / hist_count + history_blur / 8.0, max=1.0)
    blend = 0.25 / (8.0 + (dist_to_clamp + contrast - 8.0) * history_amt)
    blend = torch.clamp(blend, max=0.25)
    blend = torch.where(filt[..., 3] > 0.0, blend, 1.0)

    out_tm = hist_tm + (filt_rgb - hist_tm) * blend[..., None]
    result = _itm(out_tm)
    fallback = _itm(filt_rgb)
    result = torch.where(torch.isnan(result).any(dim=-1, keepdim=True),
                         fallback, result)
    meta = torch.minimum(hist_count / HISTORY_MAX, 1.0 - cur_history_blur)
    return torch.cat([result, meta[..., None]], dim=-1)
