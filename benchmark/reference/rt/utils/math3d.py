"""Row-vector, left-handed 3-D math matching DirectXMath conventions.

Torch port of raytracedggx_tpu/utils/math3d.py: ``v_row @ M``,
left-handed clip space with z in [0, 1].  float32 throughout; matrices
are built on the CPU (they are tiny); callers move them to a device.
"""

from __future__ import annotations

import functools

import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def perspective_fov_lh(fov_y: float, aspect: float, z_near: float,
                       z_far: float):
    """XMMatrixPerspectiveFovLH equivalent (row-vector convention)."""
    h = 1.0 / torch.tan(_f32(fov_y) * 0.5)
    w = h / aspect
    rng = z_far / (z_far - z_near)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = rng
    m[2, 3] = 1.0
    m[3, 2] = -rng * z_near
    return m


def look_at_lh(eye, focus, up):
    """XMMatrixLookAtLH equivalent (row-vector convention)."""
    eye, focus, up = _f32(eye), _f32(focus), _f32(up)
    r2 = normalize(focus - eye)                       # forward (+z)
    r0 = normalize(torch.linalg.cross(up, r2))        # right
    r1 = torch.linalg.cross(r2, r0)                   # true up
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = r0, r1, r2
    m[3, :3] = -torch.stack([r0 @ eye, r1 @ eye, r2 @ eye])
    m[3, 3] = 1.0
    return m


def rotation_y(angle):
    """XMMatrixRotationY equivalent (row-vector convention)."""
    a = _f32(angle)
    c, s = torch.cos(a), torch.sin(a)
    m = torch.eye(4, dtype=torch.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def scaling(sx, sy, sz):
    return torch.diag(_f32([sx, sy, sz, 1.0]))


def translation(tx, ty, tz):
    m = torch.eye(4, dtype=torch.float32)
    m[3, :3] = _f32([tx, ty, tz])
    return m


def normalize(v, dim=-1):
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * torch.sum(i * n, dim=-1, keepdim=True) * n


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def const(values, like):
    """The small constant tensor ``values`` on ``like``'s device and dtype,
    built once per (values, dtype, device).  A ``new_tensor`` per frame
    copies from pageable host memory and waits on the stream, which a
    frame captured into a CUDA graph cannot do."""
    return _const(tuple(values), like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)
