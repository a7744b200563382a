"""The benchmark of ``raytracedggx_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell named in ``BENCHMARK.json`` (its configuration and traffic
mix are ``configs/<name>.json`` and ``traffic/<name>.json``): the scene
drawn from the seed, the program's set-up, a window of ``--seconds`` of
its captured frame loop (``harness.py``), then the comparison of the
kept frames with the plain reference (``judge.py``).  With ``--trace 1``
a profiled stretch of the same loop follows the window, and the cell's
per-layer metrics are reported in place of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames issued in the window), ``failed`` (kept frames
the comparison rejects), ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Without a CUDA device, with fewer
devices than the cell asks for, without the program beside this
directory, or with JAX loaded once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

from spec import Refused

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "raytracedggx_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracedggx_tpu")
TRACE_FRAMES = 40            # frames in the traced stretch
# kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there builds (the port's own nvcc build is in its package)
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / ".bench_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / ".bench_cache" / "triton"}


def process_start() -> float:
    """This process's start on ``time.time``'s clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def forbidden_modules() -> list:
    """Top-level names in sys.modules that this process must not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed ({e.__class__.__name__})"
    return out[0].strip() if out else "nvidia-smi printed nothing"


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {chips}")
    return torch.device("cuda", 0)


def run(cell, seed: int, seconds: float, trace: bool, device,
        renderer_cls=None, log=print, trace_frames=TRACE_FRAMES):
    """The whole run after the device checks; returns the result dict.
    renderer_cls stands in for the program's ``Renderer`` (the fault
    tests); trace_frames is the traced stretch's length."""
    import torch

    import devtrace
    import judge
    import spec
    from harness import Draw, set_up, window

    cfg, traffic = cell.config, cell.traffic
    draw = Draw.of(seed)
    r, state, prog, arrays = set_up(cfg, traffic, draw, device, T_START,
                                    renderer_cls)
    state = window(r, state, prog, traffic, draw, seconds, device)
    forbidden = forbidden_modules()
    if forbidden:
        raise Refused(f"loaded once the window closed: {forbidden}")
    frame_ms = prog.wall_s * 1e3 / prog.frames
    rays = sum(prog.live_rays.values())
    iv, half = prog.intervals_ms, len(prog.intervals_ms) // 2
    log(json.dumps({"live_rays": prog.live_rays, "mrays_per_s":
                    rays / frame_ms / 1e3, "frame_ms": frame_ms,
                    "frames": prog.frames, "triangles": prog.triangles,
                    "capture_launches": prog.capture_launches,
                    "setup_phases": prog.setup_phases,
                    "interval_ms": {"median": statistics.median(iv),
                                    "min": min(iv), "max": max(iv),
                                    "halves": [statistics.mean(iv[:half]),
                                               statistics.mean(iv[half:])]
                                    if half else None},
                    "draw": vars(draw), "card": card()
                    if device.type == "cuda" else str(device)}))
    tr, trace_s = None, 0.0
    if trace:
        t = time.time()
        state, dev_ops, host_ops, wall = devtrace.profile(
            r, state, traffic, device, trace_frames)
        tr = devtrace.Trace(
            frames=trace_frames, wall_s=wall, device_ops=dev_ops,
            busy_s=devtrace.union_s((a, b) for _, a, b in dev_ops),
            host_ms_per_frame=prog.host_s * 1e3 / prog.frames,
            live_rays=prog.live_rays, triangles=prog.triangles,
            width=cfg["width"], height=cfg["height"], peaks=spec.peaks(),
            roofline=lambda k: spec.reader("roofline", k),
            gaps=devtrace.idle_gaps(dev_ops, host_ops))
        trace_s = time.time() - t
    if device.type == "cuda":
        prog.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    # the program's state goes before the reference runs on the device
    kept = prog.kept
    del r, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.time()
    ref = judge.reference_for(cfg, traffic, arrays, device)
    numbers, each = judge.compare(
        kept, judge.reference_outputs(ref, kept, draw, float(traffic["dt"])))
    log(json.dumps({"reference_s": time.time() - t, "reference_peak_bytes":
                    int(torch.cuda.max_memory_allocated(device))
                    if device.type == "cuda" else None, "trace_s": trace_s,
                    "kept_frames": [k.done for k in kept], "each": each}))
    failed = sum(not judge.verdict(g, cell.limits) for g in each)
    checks = {n: {"value": numbers[n], "limit": cell.limits[n]}
              for n in judge.NUMBERS if n in cell.limits}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader("metrics", m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": spec.reader("e2e", m["name"])
                               .read(prog), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if device.type == "cuda"
                   else device.type,
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device),
                   "count": cell.chips, "memory_peak_bytes": prog.peak_bytes}
    out = {"correct": judge.verdict(numbers, cell.limits) and failed == 0,
           "attempted": prog.frames, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        out["breakdown"] = devtrace.breakdown(tr)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    try:
        if not (ROOT / PROGRAM / "__init__.py").exists():
            raise Refused(f"no {PROGRAM} package at {ROOT}")
        sys.path.insert(0, str(ROOT))
        import spec

        cell = spec.find_cell(a.workload)
        device = require_devices(cell.chips)
        result = run(cell, a.seed, a.seconds, bool(a.trace), device)
        forbidden = forbidden_modules()
        if forbidden:
            raise Refused(f"loaded by the end of the run: {forbidden}")
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
