"""The ``taa_device_ms`` reader on synthetic traces: TS's launches by the
names a CUDA trace gives them, summed over the stretch and divided by its
frames; None where the program launched no such kernel."""

import pytest

import devtrace
import spec


def _trace(device_ops, frames):
    return devtrace.Trace(
        frames=frames, wall_s=0.05, device_ops=device_ops,
        busy_s=devtrace.union_s((a, b) for _, a, b in device_ops),
        host_ms_per_frame=1.5,
        live_rays={"primary": 1000, "reflection": 600},
        triangles={"ground": 12, "model": 1280}, width=40, height=25,
        peaks={"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13})


TS = ("void (anonymous namespace)::temporal_ss_kernel<unsigned short>"
      "(float const*, long long, long long, long long, unsigned short "
      "const*, long long, long long, long long, float const*, long long, "
      "long long, long long, int, int, int, float, float, int, float*)")


def test_taa_reader_sums_its_launches_per_frame():
    """Three frames of one 30 us launch among the f16 cast and the stage
    marks: 30 us a frame; nothing else is counted."""
    ops, t = [], 0.0
    for _ in range(3):
        ops.append(("rtggx_mark_taa", t, t + 1.0))
        ops.append((TS, t + 2.0, t + 32.0))
        ops.append(("void at::native::elementwise_kernel<128, 4>", t + 33.0,
                    t + 40.0))
        ops.append(("rtggx_mark_tonemap", t + 41.0, t + 42.0))
        t += 100.0
    got = spec.reader("metrics", "taa_device_ms").read(_trace(ops, frames=3))
    assert got == pytest.approx(30.0 / 1e3)


def test_taa_reader_is_none_without_the_kernel():
    """The parent's frame (the TAA as torch operations) reports no
    taa_device_ms."""
    ops = [("rtggx_mark_taa", 0.0, 1.0),
           ("void at::native::CatArrayBatchedCopy", 2.0, 30.0),
           ("void at::native::vectorized_gather_kernel", 30.0, 100.0)]
    assert spec.reader("metrics", "taa_device_ms").read(
        _trace(ops, frames=1)) is None
