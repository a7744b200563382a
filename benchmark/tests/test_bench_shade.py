"""The ``shade_device_ms`` reader on synthetic traces: BS's launches by
the names a CUDA trace gives them, summed over the stretch and divided by
its frames; None where the program launched no such kernel."""

import pytest

import devtrace
import spec


def _trace(device_ops, frames):
    return devtrace.Trace(
        frames=frames, wall_s=0.05, device_ops=device_ops,
        busy_s=devtrace.union_s((a, b) for _, a, b in device_ops),
        host_ms_per_frame=1.5,
        live_rays={"primary": 1000, "reflection": 600, "diffuse": 300},
        triangles={"ground": 12, "model": 1280}, width=40, height=25,
        peaks={"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13})


BS = ("void (anonymous namespace)::bounce_shade_kernel((anonymous "
      "namespace)::Tables, (anonymous namespace)::Rays, unsigned short "
      "const*, long long, int, int, float*)")


def test_shade_reader_sums_its_launches_per_frame():
    """Two frames of two bounce waves each (20 us and 12 us launches)
    among K1, the un-permute gather and the stage marks: 32 us a frame;
    nothing else is counted."""
    ops, t = [], 0.0
    for _ in range(2):
        for stage, us in (("reflection", 20.0), ("diffuse", 12.0)):
            ops.append((f"rtggx_mark_{stage}", t, t + 1.0))
            ops.append(("void (anonymous namespace)::trace_instanced_kernel"
                        "<0>", t + 2.0, t + 40.0))
            ops.append((BS, t + 41.0, t + 41.0 + us))
            ops.append(("void at::native::index_elementwise_kernel<128, 4>",
                        t + 70.0, t + 80.0))
            t += 100.0
    got = spec.reader("metrics", "shade_device_ms").read(_trace(ops, 2))
    assert got == pytest.approx(32.0 / 1e3)


def test_shade_reader_is_none_without_the_kernel():
    """The parent's frame (the shading as torch operations) reports no
    shade_device_ms."""
    ops = [("rtggx_mark_reflection", 0.0, 1.0),
           ("void at::native::vectorized_gather_kernel<16, long>", 2.0,
            30.0),
           ("void at::native::elementwise_kernel<128, 2>", 30.0, 100.0)]
    assert spec.reader("metrics", "shade_device_ms").read(
        _trace(ops, frames=1)) is None


def test_shade_reader_is_listed():
    """BENCHMARK.json lists it in the frame glue layer, moving frame_ms,
    in every cell (every frame shades a reflection wave)."""
    import json
    from pathlib import Path

    bench = json.loads((Path(spec.HERE).parent / "BENCHMARK.json")
                       .read_text())
    entry = [m for m in bench["per_layer"] if m["name"] == "shade_device_ms"]
    assert entry == [{"name": "shade_device_ms", "unit": "ms",
                      "better": "lower", "source": "device_trace",
                      "layer": "frame glue", "moves": "frame_ms"}]
