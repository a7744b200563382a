"""The ``xform_device_ms`` reader on synthetic traces: XF's launches by
the names a CUDA trace gives them, summed over the stretch and divided
by its frames; None where the program launched no such kernel."""

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


XF = ("void (anonymous namespace)::instance_xform_kernel<3, 3, true>"
      "(float const*, int, long long, long long, long long, void const*, "
      "long long, int, float const*, long long, long long, int, float*)")


def test_xform_reader_sums_its_launches_per_frame():
    """Two frames of 6 launches of 12 us among other glue: 72 us a frame;
    the glue's other kernels and K1 are not counted."""
    ops, t = [], 0.0
    for _ in range(2):
        for _ in range(6):
            ops.append((XF, t, t + 12.0))
            ops.append(("void gemv2N_kernel<int, float>", t + 12.0,
                        t + 40.0))
            ops.append(("trace_instanced_kernel<0>", t + 40.0, t + 90.0))
            t += 100.0
    got = spec.reader("metrics", "xform_device_ms").read(
        _trace(ops, frames=2))
    assert got == pytest.approx(6 * 12.0 / 1e3)


def test_xform_reader_is_none_without_the_kernel():
    """The parent's frame (a gather and a cuBLAS gemv per transform)
    reports no xform_device_ms."""
    ops = [("void vectorized_gather_kernel", 0.0, 30.0),
           ("void gemv2N_kernel<int, float>", 30.0, 100.0)]
    assert spec.reader("metrics", "xform_device_ms").read(
        _trace(ops, frames=1)) is None
