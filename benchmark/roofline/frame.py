"""The whole frame: the kernels' counts (K1 every wave, K2, K3 where the
diffuse wave runs) and the TAA and tone map, each image read once and
written once: the filtered colour (4 float32), the velocity (2 float32)
and the f16 history (4) read, the history written, read again by the
tone map, and the frame (3 float32) written."""

import importlib.util
from pathlib import Path

TAA_TONEMAP_BYTES = 4 * 4 + 4 * 2 + 2 * 4 + 2 * 4 + 2 * 4 + 4 * 3


def _count(name):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"roofline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(trace):
    names = ["k1", "k2"] + (["k3"] if "diffuse" in trace.live_rays else [])
    return [_count(n) for n in names]


def bytes_per_frame(trace):
    return (sum(k.bytes_per_frame(trace) for k in _kernels(trace))
            + trace.width * trace.height * TAA_TONEMAP_BYTES)


def flops_per_frame(trace):
    return sum(k.flops_per_frame(trace) for k in _kernels(trace))
