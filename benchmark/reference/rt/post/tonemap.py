"""Final tone map + unsharp composite (PSToneMap.hlsl:13-41).

Torch port of raytracedggx_tpu/post/tonemap.py: a 5-tap cross, each tap
tone-mapped x/(x+0.5), then c0 -= 0.2 * laplacian.
"""

from __future__ import annotations

from ..denoise.temporal import _shift


def tone_map(src):
    """src: (H, W, 4) accumulated HDR (+meta alpha). Returns (H, W, 3)."""
    rgb = src[..., :3]
    center = rgb / (rgb + 0.5)
    lap = -4.0 * center
    for dy, dx in [(0, -1), (0, 1), (-1, 0), (1, 0)]:
        nb = _shift(rgb, dy, dx)
        lap = lap + nb / (nb + 0.5)
    return center - 0.2 * lap
