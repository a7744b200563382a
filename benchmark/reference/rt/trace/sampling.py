"""Sample generation: PCG hash RNG + GGX / cosine direction sampling.

Torch port of raytracedggx_tpu/trace/sampling.py (RayTracing.hlsl:92-162,
379-406).  The PCG chain is uint32 arithmetic; torch's uint32 has few
ops, so it runs in int64 with ``& 0xFFFFFFFF`` after every multiply and
add (products stay below 2^62, and right shifts of non-negative int64
are logical) — bit-exact with the reference.
"""

from __future__ import annotations

import math

import torch

from ..utils.math3d import const

TWO_PI = 2.0 * math.pi
MASK32 = 0xFFFFFFFF


def pcg(seed):
    """pcg_output_rxs_m_xs_32_32, condensed (RayTracing.hlsl:379-387).
    seed: int64 tensor holding uint32 values."""
    s = (seed * 747796405 + 1) & MASK32
    s = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & MASK32
    return (s >> 22) ^ s


def rng_float2(s, num):
    """RNG(i, num) (RayTracing.hlsl:389-392): (i/num, (RNG(i)&0xffff)/65536)."""
    x = s.to(torch.float32) / float(num)
    y = (pcg(s) & 0xFFFF).to(torch.float32) / float(0x10000)
    return torch.stack([x, y], dim=-1)


def sample_param(px, py, width, frame_index, num_samples: int = 256):
    """getSampleParam (RayTracing.hlsl:394-406).  px/py integer tensors;
    frame_index a python int or a 0-dim int64 tensor on their device (mod
    256 upstream, RayTracer.cpp:295; the renderer's frame constants hold
    it as a tensor, so a captured frame reads each replay's index)."""
    s = (py.to(torch.int64) * width + px.to(torch.int64)) & MASK32
    s = pcg(s)
    s = (s + frame_index) & MASK32
    s = pcg(s)
    return rng_float2(s % num_samples, num_samples)


def orthonormal_basis(n):
    """computeLocalToWorld (RayTracing.hlsl:129-138): rows (x, y, z=n)."""
    up = torch.where(torch.abs(n[..., 1:2]) < 0.999,
                     const((0.0, 1.0, 0.0), n), const((1.0, 0.0, 0.0), n))
    x = torch.linalg.cross(up.expand_as(n), n)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(n, x)
    return x, y


def ggx_dir(a, n, xi):
    """computeDirectionGGX (RayTracing.hlsl:92-101, 141-147): sample the
    GGX half-vector distribution around normal n (a = roughness^2)."""
    phi = TWO_PI * xi[..., 0]
    cos_t = torch.sqrt((1.0 - xi[..., 1])
                       / (1.0 + (a * a - 1.0) * xi[..., 1]))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    lx = torch.cos(phi) * sin_t
    ly = torch.sin(phi) * sin_t
    x, y = orthonormal_basis(n)
    return x * lx[..., None] + y * ly[..., None] + n * cos_t[..., None]


def uniform_sphere(xi):
    """computeLocalDirectionUS (RayTracing.hlsl:103-112)."""
    phi = TWO_PI * xi[..., 0]
    cos_t = 1.0 - 2.0 * xi[..., 1]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def cos_dir(n, xi):
    """computeDirectionCos (RayTracing.hlsl:150-162): normalize(N +
    uniform_sphere(xi)) — cosine-weighted hemisphere."""
    d = n + uniform_sphere(xi)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-20)
