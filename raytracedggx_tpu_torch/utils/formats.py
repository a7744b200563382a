"""GPU texture-format emulation (optional storage quantization).

Torch port of raytracedggx_tpu/utils/formats.py.  The reference renderer
stores intermediates in quantized formats (RayTracer.cpp:91-114,
Denoiser.cpp:46-56): RayTracingOut R11G11B10_FLOAT, Normal
R10G10B10A2_UNORM, RoughnessMetallic R8G8_UNORM, Velocity R16G16_FLOAT,
TemporalSS / Filtered R16G16B16A16_FLOAT.  These functions round-trip
float32 values through that storage precision
(``RenderConfig.emulate_formats``).
"""

from __future__ import annotations

import torch


def quantize_unorm(x, bits: int):
    """Round-trip through an n-bit UNORM channel (round half to even)."""
    maxv = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * maxv) / maxv


def quantize_f16(x):
    return x.to(torch.float16).to(torch.float32)


def _quantize_small_float(x, mantissa_bits: int):
    """Round-trip a positive float32 through a 5-exponent small float
    (e5m6 for float11, e5m5 for float10) with round-to-nearest-even, as
    D3D converts float32 to R11G11B10.  Negative inputs clamp to 0.

    The rounding is integer arithmetic on the float bits.  After the
    clamp every value is a non-negative float <= 65024, whose bit pattern
    is below 2^31, so the reference's uint32 arithmetic is exact in
    int32."""
    x = torch.clamp(x.to(torch.float32), min=0.0)
    x = torch.clamp(x, max=65024.0 if mantissa_bits == 6 else 64512.0)
    bits = x.contiguous().view(torch.int32)
    drop = 23 - mantissa_bits
    # round-to-nearest-even on the dropped mantissa bits
    bits = bits + (1 << (drop - 1)) - 1 + ((bits >> drop) & 1)
    bits = bits & ~((1 << drop) - 1)
    y = bits.view(torch.float32)
    # flush denormals (exponent below 2^-14) to zero like the GPU
    return torch.where(y < 6.103515625e-05, 0.0, y)


def quantize_r11g11b10(rgb):
    """Round-trip (..., 3) through R11G11B10_FLOAT."""
    return torch.stack([_quantize_small_float(rgb[..., 0], 6),
                        _quantize_small_float(rgb[..., 1], 6),
                        _quantize_small_float(rgb[..., 2], 5)], dim=-1)
