"""Device-time profile of the "wide", "pallas4" and "pallas" frames and
of their kernels K1, K2, K3, K5 and K4.

    python -m raytracedggx_tpu_torch.scripts.kprofile [frames]

On the stand-in model scene (``scripts/standin.py``) at 1280x720 through
``Renderer``'s default config, with ``torch.profiler`` (CPU and CUDA
activities), it prints:

* ms per frame between CUDA events, without the profiler: 60 frames
  with default materials after 5 warm-up frames, then 10 at metallic 0.5
  after 3 (as ``chip_smoke.py`` phase 4 times the "wide" path);
* per frame, over ``frames`` profiled frames (default 10) after each of
  those runs: the host wall with the profiler on, device busy time (the
  union of the device operations' intervals), the idle share of the wall,
  device operations per frame, and device ms per frame of the top kernels
  by name, with the share of the busy time that K1, K2 and K3 take;
* the same for the captured frame (``Renderer.step_n``, one frame
  captured into a CUDA graph and replayed): ms per frame of one chunk of
  60 (10 at metallic 0.5) frames between CUDA events, and one profiled
  chunk of ``frames`` frames, so the device's own time per frame shows
  once the host is out of the way;
* host time per frame by Python function (cProfile over ``frames``
  default frames, ending in a synchronize): the top functions by their
  own time, so a frame that waits on the host shows where;
* per launch: K1's device time on each of the first frame's waves, as the
  renderer hands them to ``trace_scene_wide_fused`` (primary in screen-block
  order, then the sorted reflection wave), and K2's and K3's on each axis
  over the metallic-0.5 frame's G-buffers: the median of the kernel's own
  device time over ``frames`` launches;
* the ``traversal="pallas4"`` path, then ``"pallas"``: ms per frame (20
  frames after 3 warm-up), its profile as above (device busy, idle share,
  the per-mesh kernel's share), that kernel's (K5's, K4's) mean device
  ms per launch over the profiled frames, and its median device ms per
  launch on the "wide" frame's two waves in the model instance's object
  space (``trace_tiles4`` / ``trace_tiles_flat`` with the inverse world,
  as ``trace_scene4`` / ``trace_scene_flat`` launch it);
* a last line with all of it as JSON, with the card's name and power limit.

It reads only public entry points (``Renderer`` and its ``trace_hook`` and
``geom``, ``trace_scene_wide_fused``, ``trace_tiles4``,
``trace_tiles_flat``, ``reflection_pass``, ``diffuse_pass``) and the
kernels' names (each
kernel's name in this tree and the one it had before), so one file
measures any tree of the port whose ``Renderer`` has ``trace_hook``.
Needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time

import torch

W, H = 1280, 720
TIMED, TIMED_METAL, TIMED_PER_MESH = 60, 10, 20
# device kernel names, this tree's and the ones each had before
KERNELS = {"K1": ("trace_instanced_kernel",),
           "K2": ("reflection_pass_kernel", "spatial_pass_kernel<true"),
           "K3": ("diffuse_pass_kernel", "spatial_pass_kernel<false"),
           "K5": ("trace_wide4_kernel",),
           "K4": ("trace_flat_pairs_kernel", "trace_flat_kernel")}
# the per-mesh paths: traversal -> (kernel, its Renderer.geom field)
PER_MESH = {"pallas4": ("K5", "wide"), "pallas": ("K4", "flat")}


def named(name, keys) -> bool:
    return any(k in name for k in keys)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, start_us, end_us) of every operation the device ran."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiled(fn, n):
    """Run fn() n times under torch.profiler; (device events, host ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return device_events(prof), wall


def launch_ms(events, keys):
    """(median device ms per launch, launches) of the kernel named like one
    of ``keys`` among ``events``.  The median: a profiled window now and
    then records some launches of a kernel far shorter than the rest."""
    ev = [e for e in events if named(e[0], keys)]
    if not ev:
        raise RuntimeError(f"no device time recorded for {keys!r}")
    return statistics.median(b - a for _, a, b in ev) / 1e3, len(ev)


def kernel_ms(fn, keys, n):
    """Median device ms per launch of the kernel named like one of
    ``keys`` over n runs of fn().  A profiled window now and then records
    none of the kernel's launches; it is profiled again, up to three
    windows in all."""
    for _ in range(2):
        events = profiled(fn, n)[0]
        if any(named(name, keys) for name, _, _ in events):
            return launch_ms(events, keys)
    return launch_ms(profiled(fn, n)[0], keys)


def frames_ms(renderer, state, n):
    """(state, ms per frame of n frames between CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, _, _ = renderer.step(state)
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / n


def chunk_ms(renderer, state, n):
    """(state, ms per frame of one captured step_n chunk of n frames
    between CUDA events), after a chunk that captures and warms it."""
    state, _ = renderer.step_n(state, n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = renderer.step_n(state, n)
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / n


def frame_profile(renderer, state, n, label):
    """Profile n frames; returns (state, last aux dict, summary)."""
    box = {"state": state}

    def step():
        box["state"], _, box["aux"] = renderer.step(box["state"])

    ev, wall = profiled(step, n)
    return box["state"], box["aux"], summarize(ev, wall, n, label)


def chunk_profile(renderer, state, n, label):
    """Profile one captured step_n chunk of n frames; (state, summary)."""
    box = {"state": state}

    def chunk():
        box["state"], _ = renderer.step_n(box["state"], n)

    ev, wall = profiled(chunk, 1)
    return box["state"], summarize(ev, wall, n, label)


def summarize(ev, wall, n, label):
    """Per frame of n frames profiled in ``wall`` host ms: the wall,
    device busy ms, idle share, device operations and the top kernels by
    name, each kernel's share of the busy time."""
    busy = busy_us(ev) / 1e3
    by_name = {}
    for name, a, b in ev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    share = {k: sum(v for name, v in by_name.items() if named(name, keys))
             / busy for k, keys in KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    res = dict(wall_ms=wall / n, busy_ms=busy / n, idle=1.0 - busy / wall,
               ops=len(ev) / n, share=share,
               top={name[:90]: ms / n for name, ms in top})
    for k in ("K4", "K5"):  # all of a per-mesh frame's launches of it
        dt = [b - a for name, a, b in ev if named(name, KERNELS[k])]
        if dt:
            res[f"{k}_ms_per_launch"] = sum(dt) / len(dt) / 1e3
            res[f"{k}_launches"] = len(dt)
    print(f"{label}: wall {res['wall_ms']:.4f} ms/frame (profiler on), "
          f"device busy {res['busy_ms']:.4f} ms/frame, idle share "
          f"{res['idle']:.4f}, {res['ops']:.1f} device ops/frame; share of "
          f"busy " + ", ".join(f"{k} {v:.4f}" for k, v in share.items()),
          flush=True)
    for name, ms in res["top"].items():
        print(f"    {ms:9.4f} ms/frame  {name}")
    return res


def host_profile(renderer, state, n):
    """cProfile over n frames: (state, {function: own ms per frame}) of
    the top 12 functions by own time."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        state, _, _ = renderer.step(state)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    top = {f"{fn}:{line}({name})"[-90:]: tt * 1e3 / n
           for (fn, line, name), (_, _, tt, _, _) in rows}
    total = sum(v[2] for v in stats.values()) * 1e3 / n
    print(f"host: {total:.4f} ms/frame of Python (cProfile on); top own "
          f"times:", flush=True)
    for name, ms in top.items():
        print(f"    {ms:9.4f} ms/frame  {name}")
    return state, dict(total_ms=total, top=top)


def frame_waves(renderer):
    """K1's inputs over the renderer's first frame, captured through its
    ``trace_hook`` as the waves hand them to the traversal: (sw, worlds,
    [(o, d, t_min, t_max), ...]) with sw the BVH refit at the frame's
    instance worlds, one entry per wave (primary in screen-block order,
    then the sorted reflection wave; the diffuse wave when it is live) and
    t_max per ray."""
    waves, box = [], {}

    def hook(sw, o, d, t_min, t_max):
        box["sw"] = sw
        t = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
        waves.append((o.contiguous(), d.contiguous(), float(t_min),
                      t.expand(o.shape[0]).contiguous()))

    renderer.trace_hook = hook
    try:
        state, _, _ = renderer.step(renderer.init_state())
    finally:
        renderer.trace_hook = None
    worlds = renderer.scene.worlds(state.angle).to(renderer.device)
    return box["sw"], worlds, waves


def per_mesh_profile(scene, waves, worlds, n, out, traversal):
    """A per-mesh path ("pallas4" or "pallas"): frame ms, its profile, and
    its kernel (K5 or K4) per launch on the "wide" frame's waves in the
    model instance's object space."""
    from ..engine import RenderConfig, Renderer
    from ..ops.traverse_cuda import inv_rows, trace_tiles_flat
    from ..ops.wide import trace_tiles4

    k, field = PER_MESH[traversal]
    wrapper = {"K4": trace_tiles_flat, "K5": trace_tiles4}[k]
    r = Renderer(scene, config=RenderConfig(traversal=traversal),
                 device="cuda")
    state = r.init_state()
    for _ in range(3):
        state, _, _ = r.step(state)
    state, ms = frames_ms(r, state, TIMED_PER_MESH)
    out[f"{traversal}_frame_ms"] = ms
    print(f"{traversal} frame: {ms:.4f} ms over {TIMED_PER_MESH} frames",
          flush=True)
    state, _, prof = frame_profile(r, state, n, f"{traversal} frame")
    out[f"{traversal}_frame"] = prof
    print(f"{k} in the {traversal} frame: {prof[f'{k}_ms_per_launch']:.4f} "
          f"ms per launch (mean) over {prof[f'{k}_launches']} launches",
          flush=True)
    model = scene.mesh_ids.index(1)        # the instance of mesh 1
    tree = getattr(r.geom, field)[1]
    inv = inv_rows(torch.linalg.inv(worlds))[model].contiguous()
    for label, (o, d, t_min, t_max) in zip(("primary", "reflection"), waves):
        ms, cnt = kernel_ms(lambda: wrapper(tree, o, d, t_min, t_max, inv),
                            KERNELS[k], n)
        out[f"{k}_{label}_ms"] = ms
        print(f"{k} {label} wave ({o.shape[0]} rays, model instance, "
              f"{tree.num_nodes} nodes): {ms:.4f} ms per launch over {cnt} "
              f"launches", flush=True)


def main(argv=None) -> int:
    from ..denoise import tm
    from ..engine import Renderer
    from ..ops.scene_wide import trace_scene_wide_fused
    from ..ops.spatial_cuda import diffuse_pass, reflection_pass
    from .standin import model_scene

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("kprofile needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    scene = model_scene()
    renderer = Renderer(scene, device="cuda")
    out = dict(card=card, leaf_size=renderer.config.wide_leaf_size)

    sw, worlds, waves = frame_waves(renderer)
    for label, (o, d, t_min, t_max) in zip(("primary", "reflection"), waves):
        ms, cnt = kernel_ms(lambda: trace_scene_wide_fused(sw, o, d, t_min,
                                                           t_max),
                            KERNELS["K1"], n)
        out[f"K1_{label}_ms"] = ms
        print(f"K1 {label} wave ({o.shape[0]} rays, L "
              f"{renderer.config.wide_leaf_size}): {ms:.4f} ms per launch "
              f"over {cnt} launches", flush=True)

    state = renderer.init_state()
    for _ in range(5):
        state, _, _ = renderer.step(state)
    state, out["frame_ms"] = frames_ms(renderer, state, TIMED)
    print(f"frame: {out['frame_ms']:.4f} ms over {TIMED} frames", flush=True)
    state, _, out["frame"] = frame_profile(renderer, state, n, "frame")
    state, out["captured_frame_ms"] = chunk_ms(renderer, state, TIMED)
    print(f"captured frame: {out['captured_frame_ms']:.4f} ms over one "
          f"step_n chunk of {TIMED} frames", flush=True)
    state, out["captured_frame"] = chunk_profile(renderer, state, n,
                                                 "captured frame")
    state, out["host"] = host_profile(renderer, state, n)
    for mesh_idx in (0, 1):
        renderer.set_metallic(mesh_idx, 0.5)
    for _ in range(3):
        state, _, _ = renderer.step(state)
    state, out["frame_metal_ms"] = frames_ms(renderer, state, TIMED_METAL)
    print(f"frame metallic 0.5: {out['frame_metal_ms']:.4f} ms over "
          f"{TIMED_METAL} frames", flush=True)
    state, aux, out["frame_metal"] = frame_profile(renderer, state, n,
                                                   "frame metallic 0.5")
    state, out["captured_frame_metal_ms"] = chunk_ms(renderer, state,
                                                     TIMED_METAL)
    print(f"captured frame metallic 0.5: "
          f"{out['captured_frame_metal_ms']:.4f} ms over one step_n chunk "
          f"of {TIMED_METAL} frames", flush=True)
    state, out["captured_frame_metal"] = chunk_profile(
        renderer, state, n, "captured frame metallic 0.5")

    normal, depth = aux["normal"], aux["depth"]
    rough = aux["rough_metal"][..., 0].contiguous()
    metal = aux["rough_metal"][..., 1].contiguous()
    refl, diff = tm(aux["refl"]).contiguous(), tm(aux["diff"]).contiguous()
    for axis in (1, 0):
        for k, fn in (("K2", lambda: reflection_pass(refl, normal, rough,
                                                     depth, W, H, axis)),
                      ("K3", lambda: diffuse_pass(diff, normal, metal, depth,
                                                  axis))):
            ms, cnt = kernel_ms(fn, KERNELS[k], n)
            out[f"{k}_axis{axis}_ms"] = ms
            print(f"{k} axis {axis}: {ms:.4f} ms per pass over {cnt} "
                  f"launches", flush=True)
    for traversal in PER_MESH:
        per_mesh_profile(scene, waves, worlds, n, out, traversal)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
