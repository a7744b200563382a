"""Command-line renderer: the app shell of the PyTorch/CUDA port.

    python -m raytracedggx_tpu_torch.engine.cli -mesh <file> [x y z scale]

Port of raytracedggx_tpu/engine/cli.py, flag for flag.  It replaces
Main.cpp + Win32Application + the hotkey surface with a headless CLI whose
flags mirror the reference's (ParseCommandLineArgs,
RayTracedGGX.cpp:462-511):

  -mesh <file> [x y z scale]   model OBJ + position/scale
  -env <file>                  DDS environment probe (cube map)
  -warp                        render on the CPU (the plain versions of
                               the kernels); without it the CUDA card

plus headless controls: --frames, --out, --width/--height, --screenshot
(the F11 analog), --metallic i v (the up/down-arrow analog), --no-spatial /
--no-temporal, --pause, --bary ndc, --emulate-formats, and --interactive
(the hotkeys over stdin).  ``--kernels pallas``, the reference's name for
its filter kernels, means the port's kernels K2 / K3 ("cuda").  Without
``-warp`` and without a CUDA device the renderer raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="raytracedggx_tpu_torch",
        description="PyTorch/CUDA RayTracedGGX renderer")
    p.add_argument("-mesh", nargs="+", default=None,
                   help="<file> [x y z scale]")
    p.add_argument("-env", default=None, help="DDS environment cube map")
    p.add_argument("-warp", action="store_true",
                   help="render on the CPU (the reference's WARP "
                        "software-device fallback analog)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--dt", type=float, default=1 / 60,
                   help="fixed timestep (animation)")
    p.add_argument("--pause", action="store_true",
                   help="freeze animation (Space analog)")
    p.add_argument("--out", default="frame.png", help="output PNG path")
    p.add_argument("--screenshot", type=int, default=0,
                   help="also save every Nth frame (F11 analog)")
    p.add_argument("--metallic", nargs=2, action="append", default=[],
                   metavar=("MESH", "VALUE"), help="set mesh metallic")
    p.add_argument("--extra-instance", nargs=4, action="append", default=[],
                   metavar=("X", "Y", "Z", "SCALE"),
                   help="add another animated model instance "
                        "(multi-instance TLAS)")
    p.add_argument("--no-spatial", action="store_true")
    p.add_argument("--no-temporal", action="store_true")
    p.add_argument("--no-async", action="store_true",
                   help="run the refit on the frame's own stream (the 'A' "
                        "hotkey toggle)")
    p.add_argument("--bary", choices=["direct", "ndc"], default="direct")
    p.add_argument("--emulate-formats", action="store_true")
    p.add_argument("--kernels", choices=["auto", "xla", "pallas", "cuda"],
                   default="auto",
                   help="filter implementation (the V-toggle analog); "
                        "pallas = cuda")
    p.add_argument("--traversal",
                   choices=["auto", "wide", "pallas", "pallas4", "jax"],
                   default="auto", help="traversal backend")
    p.add_argument("--interactive", action="store_true",
                   help="runtime interaction REPL over stdin: the "
                        "reference's hotkey/mouse surface "
                        "(RayTracedGGX.cpp:365-455); type 'help'")
    p.add_argument("--frames-per-cmd", type=int, default=8,
                   help="frames rendered between interactive commands")
    p.add_argument("--stats", action="store_true", help="print fps line")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of the run")
    p.add_argument("--log", default=None, metavar="JSONL",
                   help="append per-frame wall-time metrics to a JSONL file")
    p.add_argument("--stage-times", action="store_true",
                   help="print each stage's ms per frame, read from the "
                   "frame's stage marks (GPU-timestamp analog)")
    return p.parse_args(argv)


# the reference CLI's defaults (raytracedggx_tpu/engine/cli.py), in the
# reference's asset directory
REFERENCE_ASSETS = os.path.join(os.sep, "root", "reference", "Bin", "Assets")
DEFAULT_MESH = os.path.join(REFERENCE_ASSETS, "dragon.obj")
DEFAULT_ENV = os.path.join(REFERENCE_ASSETS, "rnl_cross.dds")

# the reference's --kernels names -> the port's
KERNELS = {"pallas": "cuda"}

INTERACTIVE_HELP = """commands (one per line; blank line = render a batch):
  pause | space          toggle animation pause          (Space)
  left | right           cycle the selected mesh         (arrow keys)
  up | down              metallic +-0.25 on selection    (arrow keys)
  v                      toggle filter kernel variant    ('V')
  a                      toggle async-compute split      ('A')
  shot | f11             save a screenshot now           (F11)
  drag DX DY             mouse-orbit by DX,DY pixels     (left-drag)
  wheel DZ               dolly DZ wheel notches          (mouse wheel)
  run N                  render N frames
  help                   this text
  quit                   finish (writes --out)"""


def _image(frame):
    """A frame as an (H, W, 3) numpy image in [0, 1] (waits for it)."""
    return np.clip(frame.float().cpu().numpy(), 0, 1)


def _sync(r):
    if r.device.type == "cuda":
        import torch

        torch.cuda.synchronize(r.device)


def print_stage_times(stage_ms: dict, device):
    """One line per stage of the frame: its ms per frame between its
    stage mark and the next (device time on a card, host time on the
    CPU)."""
    clock = "device" if device.type == "cuda" else "host"
    print(f"stage times, ms per frame ({clock} clock, stage marks):")
    for stage, ms in stage_ms.items():
        print(f"{stage}_ms: {ms:.3f}")


def interactive_loop(r, state, args, scene, mesh_file, stream=None):
    """The reference's runtime input surface (OnKeyUp hotkeys
    RayTracedGGX.cpp:365-398, OnMouseMove/OnMouseWheel orbit :401-455)
    as a headless REPL: commands arrive on stdin (or any line iterable),
    each followed by a rendered frame batch and a stats line (the
    window-title loop, CalculateFrameStats :741-777, done headless).  'v'
    switches the filters between the kernels ("cuda"; on the CPU "auto",
    their plain versions) and the plain passes ("xla")."""
    from ..io import write_png
    from ..scene.camera import OrbitController
    from .stats import FrameStats

    stream = stream if stream is not None else sys.stdin
    orbit = OrbitController(r.camera)
    cam = None
    stats = FrameStats()
    paused = args.pause
    num_mesh = len(set(scene.mesh_ids))
    # per-MESH metallic (m_metallics, RayTracedGGX.cpp:367): seed from the
    # first instance of each mesh
    rm = r.materials.rough_metals.cpu().numpy()
    metallics = [1.0] * num_mesh
    seen = set()
    for inst, mid in enumerate(scene.mesh_ids):
        if mid not in seen:
            seen.add(mid)
            metallics[mid] = float(rm[inst, 1])
    current_mesh = 0
    # V is on when the filter kernels run: never on the CPU, where "auto"
    # takes the same plain passes as "xla"
    kernels_on = r.kernels != "xla" and r.device.type == "cuda"
    shots = 0
    frame = None

    def render_batch(n):
        nonlocal state, frame
        for _ in range(n):
            state, frame, _ = r.step(state, dt=0.0 if paused else args.dt,
                                     cam=cam)
            stats.tick()
        _sync(r)
        print(stats.title(
            mesh=f"{current_mesh}", metallic=f"{metallics[current_mesh]:g}",
            V="on" if kernels_on else "off",
            A="on" if r.config.async_compute else "off",
            paused="yes" if paused else "no"), flush=True)

    render_batch(args.frames_per_cmd)
    for line in stream:
        toks = line.strip().lower().split()
        cmd = toks[0] if toks else ""
        if cmd in ("quit", "exit", "q"):
            break
        elif cmd in ("pause", "space"):
            paused = not paused
        elif cmd == "left":
            current_mesh = (current_mesh + num_mesh - 1) % num_mesh
        elif cmd == "right":
            current_mesh = (current_mesh + 1) % num_mesh
        elif cmd in ("up", "down"):
            step = 0.25 if cmd == "up" else -0.25
            metallics[current_mesh] = float(
                np.clip(metallics[current_mesh] + step, 0.0, 1.0))
            r.set_metallic(current_mesh, metallics[current_mesh])
        elif cmd == "v":
            kernels_on = not kernels_on
            on = "cuda" if r.device.type == "cuda" else "auto"
            r.set_kernels(on if kernels_on else "xla")
        elif cmd == "a":
            r.set_async_compute(not r.config.async_compute)
        elif cmd in ("shot", "f11"):
            shots += 1
            path = (f"{os.path.splitext(args.out)[0]}"
                    f"_shot{shots:03d}.png")
            if frame is not None:
                write_png(path, _image(frame))
                print(f"screenshot {path}", flush=True)
        elif cmd == "drag" and len(toks) == 3:
            orbit.drag(float(toks[1]), float(toks[2]))
            cam = orbit.arrays()
        elif cmd == "wheel" and len(toks) == 2:
            orbit.wheel(float(toks[1]))
            cam = orbit.arrays()
        elif cmd == "run" and len(toks) == 2:
            render_batch(int(toks[1]))
            continue
        elif cmd == "help":
            print(INTERACTIVE_HELP, flush=True)
            continue
        elif cmd not in ("",):
            print(f"? unknown command: {line.strip()} (try 'help')",
                  flush=True)
            continue
        render_batch(args.frames_per_cmd)
    return state, frame


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.warp else "cuda"

    from ..io import write_png
    from ..scene import Scene
    from .renderer import RenderConfig, Renderer
    from .stats import FrameStats

    mesh_file = DEFAULT_MESH
    pos_scale = (0.0, 0.0, 0.0, 1.0)
    if args.mesh:
        mesh_file = args.mesh[0]
        vals = [float(v) for v in args.mesh[1:5]]
        pos_scale = tuple(vals + list(pos_scale[len(vals):]))

    env = None
    env_file = args.env or (DEFAULT_ENV if os.path.exists(DEFAULT_ENV)
                            else None)
    if env_file and os.path.exists(env_file):
        try:
            from ..io.dds import load_cubemap_env
            env = load_cubemap_env(env_file, device)
        except Exception as e:  # pragma: no cover
            print(f"warning: env load failed ({e}); procedural sky",
                  file=sys.stderr)

    scene = Scene.create(mesh_file, pos_scale=pos_scale,
                         extra_instances=tuple(
                             tuple(float(v) for v in e)
                             for e in args.extra_instance))
    for midx, val in args.metallic:
        scene.materials.set_metallic(int(midx), float(val))

    cfg = RenderConfig(width=args.width, height=args.height,
                       bary_mode=args.bary,
                       spatial=not args.no_spatial,
                       temporal=not args.no_temporal,
                       emulate_formats=args.emulate_formats,
                       kernels=KERNELS.get(args.kernels, args.kernels),
                       traversal=args.traversal,
                       async_compute=not args.no_async)
    r = Renderer(scene, env=env, config=cfg, device=device)
    state = r.init_state()
    stats = FrameStats()

    if args.interactive:
        state, frame = interactive_loop(r, state, args, scene, mesh_file)
        if frame is not None:
            write_png(args.out, _image(frame))
            print(f"wrote {args.out} (interactive session)")
        return

    profile_ctx = run = None
    if args.profile or args.stage_times:
        from .profiler import trace_frames
        profile_ctx = trace_frames(args.profile)
        run = profile_ctx.__enter__()

    log_f = open(args.log, "a") if args.log else None

    frame = None
    dt = 0.0 if args.pause else args.dt
    for i in range(args.frames):
        state, frame, _ = r.step(state, dt)
        if args.screenshot and (i + 1) % args.screenshot == 0:
            write_png(f"{os.path.splitext(args.out)[0]}_{i + 1:04d}.png",
                      _image(frame))
        step_dt = stats.tick()
        if log_f:
            log_f.write(json.dumps({"frame": i, "wall_ms": step_dt * 1e3,
                                    "fps_window": stats.fps}) + "\n")
        if args.stats and i % 16 == 15:
            _sync(r)
            print(stats.title(mesh=os.path.basename(mesh_file)))
    if log_f:
        log_f.close()

    _sync(r)
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        if args.profile:
            print(f"profiler trace in {args.profile}")
    if args.stage_times:
        from . import spans
        print_stage_times(spans.stage_ms(spans.mark_events(run.events)),
                          r.device)
    write_png(args.out, _image(frame))
    print(f"wrote {args.out} ({args.frames} frames, "
          f"{cfg.width}x{cfg.height})")


if __name__ == "__main__":
    main()
