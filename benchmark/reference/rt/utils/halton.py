"""Halton low-discrepancy sequence for per-frame sub-pixel jitter.

The reference jitters the projection by ``IncrementalHalton()`` per frame
(RayTracer.cpp:253-258; declared XUSGAdvanced.h:829-834, implementation is
binary-only).  We provide the standard radical-inverse Halton sequence with
bases (2, 3); frame i maps to ``(halton(i+1, 2), halton(i+1, 3))`` in
[0, 1)^2, converted by the caller to a +-1-pixel NDC bias exactly as the
reference does: ``projBias = (h * 2 - 1) / viewport``.
"""

from __future__ import annotations

import numpy as np


def halton(i: int, base: int) -> float:
    f = 1.0
    r = 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton2(i: int) -> np.ndarray:
    """2-D Halton point for frame index i (1-based internally)."""
    return np.array([halton(i + 1, 2), halton(i + 1, 3)], np.float32)


def halton_table(n: int) -> np.ndarray:
    """Precomputed (n, 2) Halton table so a jitted frame loop can index it."""
    return np.stack([halton2(i) for i in range(n)]).astype(np.float32)
