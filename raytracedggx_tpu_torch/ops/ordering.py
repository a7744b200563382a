"""Ray orderings for traversal coherence.

Torch port of raytracedggx_tpu/ops/traverse_pallas.py:266-396
(``block_order``, ``BlockOrder``, ``make_block_order`` and
``sort_rays_morton``).  With one ray per thread (kernel K1) an ordering
changes no output, only which rays share a warp: screen blocks for the
primary wave, dead | direction class | origin Morton for bounces.  The
sort is ``torch.sort(stable=True)`` on an int64 key, and the inverse
permutation is a scatter (``inv[order] = arange``) instead of the
reference's argsort of the permutation (a TPU sort-vs-scatter trade).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.morton import morton3d


def block_order(width: int, height: int, block_w: int = 32,
                block_h: int = 32):
    """(order, inverse) numpy permutations: row-major pixel order ->
    2D-block order (for viewports no aligned block tiling divides)."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    by = ys // block_h
    bx = xs // block_w
    key = (((by * ((width + block_w - 1) // block_w) + bx)
            * block_h + (ys % block_h)) * block_w + (xs % block_w))
    order = np.argsort(key.ravel(), kind="stable").astype(np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=np.int64)
    return order, inv


class BlockOrder:
    """Screen-block ordering applied as reshape + transpose of (R, C)
    row-major rows (block_h | height and block_w | width)."""

    def __init__(self, width: int, height: int, block_w: int = 64,
                 block_h: int = 16):
        assert width % block_w == 0 and height % block_h == 0
        self.width, self.height = width, height
        self.bw, self.bh = block_w, block_h

    def permute(self, x):
        """(R, C) row-major -> block order."""
        h, w, bh, bw = self.height, self.width, self.bh, self.bw
        x = x.reshape(h // bh, bh, w // bw, bw, x.shape[-1])
        return x.transpose(1, 2).reshape(h * w, -1)

    def unpermute(self, x):
        """(R, C) block order -> row-major."""
        h, w, bh, bw = self.height, self.width, self.bh, self.bw
        x = x.reshape(h // bh, w // bw, bh, bw, x.shape[-1])
        return x.transpose(1, 2).reshape(h * w, -1)


def make_block_order(width: int, height: int, device=None):
    """BlockOrder when an aligned tiling exists, else (order, inverse)
    index tensors."""
    for bw, bh in ((64, 16), (32, 32), (128, 8)):
        if width % bw == 0 and height % bh == 0:
            return BlockOrder(width, height, bw, bh)
    order, inv = block_order(width, height)
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(inv, device=device))


def sort_rays_morton(ray_o, ray_d, scene_lo, scene_hi, active=None,
                     dir_bits: int = 3):
    """(order, inverse) for an incoherent bounce wave, from the
    reference's single 32-bit key (traverse_pallas.py:326-380), held in
    int64 bit for bit, so the order is the reference's: the dead bit 31,
    then the direction class (``dir_bits`` 3: the octant; 6: the octant
    and the axis-magnitude order, ~30 degree cones), then the Morton
    code's leading bits."""
    if dir_bits not in (3, 6):
        raise ValueError(f"dir_bits must be 3 or 6, got {dir_bits}")
    dclass = ((ray_d[:, 0] >= 0).to(torch.int64)
              | ((ray_d[:, 1] >= 0).to(torch.int64) << 1)
              | ((ray_d[:, 2] >= 0).to(torch.int64) << 2))
    if dir_bits == 6:
        ax, ay, az = ray_d[:, 0].abs(), ray_d[:, 1].abs(), ray_d[:, 2].abs()
        dclass = (dclass | ((ax > az).to(torch.int64) << 3)
                  | ((ay > az).to(torch.int64) << 4)
                  | ((ax > ay).to(torch.int64) << 5))
    code = morton3d(ray_o, scene_lo, scene_hi)
    key = (dclass << (31 - dir_bits)) | (code >> (dir_bits - 1))
    key = key & 0xFFFFFFFF                   # the reference's uint32 wrap
    if active is not None:
        key = torch.where(active, key, key | (1 << 31))
    order = torch.sort(key, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv
