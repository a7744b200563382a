"""One run of a cell: the scene drawn from the seed, the program's set-up,
the measured window of its captured frame loop, and the frames kept for
the comparison with the plain reference.

The window drives ``Renderer.step_n(state, 1)`` once per frame with at
most ``frames_in_flight`` frames outstanding (the reference
application's FrameCount fencing): a CUDA event is recorded after each
call, and before frame i is issued the host waits on frame i - 3's.  It
ends with a device sync and a host read of the last frame.  The frames
kept for the comparison are tensors the loop made anyway (``step_n``
returns a fresh history and frame each call): holding them adds no
device work to the window.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from spec import Refused, extra_instances
from standin import model_arrays, write_obj

MID_RANGE = 64     # the mid-window frame checked is drawn from [1, 64)


@dataclass
class Draw:
    """What the seed sets: the displacement's phases, the model's start
    angle, the start frame counter (jitter and RNG phase) and which
    window frame is checked besides the last."""
    phases: tuple
    angle0: float
    frame0: int
    mid: int

    @staticmethod
    def of(seed: int) -> "Draw":
        rng = np.random.default_rng(int(seed))
        phases = tuple(float(p) for p in rng.uniform(0.0, 2 * np.pi, 3))
        return Draw(phases=phases,
                    angle0=float(np.float32(rng.uniform(0.0, 2 * np.pi))),
                    frame0=int(rng.integers(0, 1024)),
                    mid=int(rng.integers(1, MID_RANGE)))


@dataclass
class Kept:
    """A frame kept for the comparison: ``done`` frames preceded it since
    the start state; ``before`` is the program's history it started from
    (None: the reference runs from its own start); ``history`` and
    ``frame`` are what the program produced."""
    done: int
    before: object
    history: object
    frame: object


@dataclass
class Program:
    setup_s: float
    setup_phases: dict          # seconds of each part of the set-up
    live_rays: dict             # per wave, from the warm-up frame
    triangles: dict             # per mesh of the scene
    capture_launches: dict
    kept: list = field(default_factory=list)
    frames: int = 0
    wall_s: float = 0.0
    intervals_ms: list = field(default_factory=list)
    host_s: float = 0.0
    peak_bytes: int = 0


class _HostEvent:
    """A CUDA event's stand-in on the CPU (the CPU rehearsal)."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def event(device):
    import torch

    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def live_rays(aux, width, height, diffuse: bool) -> dict:
    """Live rays of a frame per wave, from its G-buffers: every pixel's
    primary ray, one reflection ray per hit, one diffuse ray per hit
    below metallic 1 where the diffuse wave runs."""
    hit = aux["normal"][..., 3] > 0.5
    metal = aux["rough_metal"][..., 1]
    out = {"primary": width * height, "reflection": int(hit.sum())}
    if diffuse:
        out["diffuse"] = int((hit & (metal < 1.0)).sum())
    return out


def build(config, traffic, draw: Draw, device, renderer_cls=None):
    """(renderer, model arrays, time marks): the stand-in written as an
    OBJ under TMPDIR and loaded through ``Scene.create`` as a user's
    ``-mesh``, with the configuration's extra instances, the renderer
    built, the traffic's ``set_metallic`` calls applied."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.scene import Scene

    marks = {"start": time.time()}
    arrays = model_arrays(config["model_level"], draw.phases,
                          config["model_tessellation"])
    with tempfile.TemporaryDirectory(prefix="rtggx-benchmark-") as tmp:
        path = os.path.join(tmp, "model.obj")
        write_obj(path, arrays)
        marks["model_and_obj"] = time.time()
        scene = Scene.create(path, pos_scale=tuple(config["model_pos_scale"]),
                             extra_instances=extra_instances(config))
        marks["obj_parse"] = time.time()
    cfg = RenderConfig(width=config["width"], height=config["height"],
                       spatial=config["spatial"], temporal=config["temporal"],
                       kernels=config["kernels"],
                       traversal=config["traversal"])
    r = (renderer_cls or Renderer)(scene, config=cfg, device=device)
    check_scene(config, r, draw.angle0)
    for mesh_idx, value in traffic["metallic"].items():
        r.set_metallic(int(mesh_idx), float(value))
    marks["renderer"] = time.time()
    return r, arrays, marks


def check_scene(config, r, angle0):
    """The program renders the deployment the configuration states: its
    instances, where each of them is (the program's instance worlds at
    the start angle, bit for bit those of the plain reference's scene),
    the model's triangles, float32 products without TF32."""
    import torch

    # read before the reference's modules load: they turn TF32 off
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise Refused("TF32 is on; the configuration states float32")
    from reference.rt.scene.scene import instance_worlds

    found = {"instances": len(r.scene.mesh_ids),
             "model_triangles": r.scene.meshes[1].num_triangles}
    for key, value in found.items():
        if value != config[key]:
            raise Refused(f"the program built {key} {value}, the "
                          f"configuration states {config[key]}")
    angle = np.float32(angle0)
    stated = instance_worlds(angle, np.asarray(config["model_pos_scale"],
                                               np.float32),
                             extra_instances(config))
    if not torch.equal(r.scene.worlds(angle).cpu(), stated):
        raise Refused("the program's instance worlds at the start angle "
                      "are not those that model_pos_scale and "
                      "extra_instances state")


def set_up(config, traffic, draw: Draw, device, t_start: float,
           renderer_cls=None):
    """(renderer, state, Program, model arrays): everything before the
    window, ending in a synchronized device; ``setup_s`` counts from
    ``t_start`` (process start, on ``time.time``'s clock)."""
    import torch

    dt = float(traffic["dt"])
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    r, arrays, marks = build(config, traffic, draw, device, renderer_cls)
    state = r.init_state()._replace(angle=np.float32(draw.angle0),
                                    frame=draw.frame0)
    if state.history.dtype != torch.float16:
        raise Refused(f"a {state.history.dtype} history; the configuration "
                      "states float16")
    # one eager frame: the live rays are counted from it
    state, frame, aux = r.step(state, dt)
    rays = live_rays(aux, config["width"], config["height"],
                     diffuse=bool((np.asarray(list(
                         traffic["metallic"].values())) < 1.0).any()))
    kept = [Kept(done=0, before=None, history=state.history, frame=frame)]
    del aux
    sync(device)
    marks["warm_up_step"] = time.time()
    # the first step_n call captures the graph
    state, frame = r.step_n(state, 1, dt=dt)
    kept.append(Kept(done=1, before=None, history=state.history,
                     frame=frame))
    frame.cpu()
    sync(device)
    marks["capture"] = time.time()
    tris = {"ground": r.scene.meshes[0].num_triangles,
            "model": r.scene.meshes[1].num_triangles}
    names = list(marks)
    phases = {"before_set_up": t0 - t_start, "cuda_init": marks["start"] - t0}
    phases.update({b: marks[b] - marks[a] for a, b in zip(names, names[1:])})
    prog = Program(setup_s=time.time() - t_start, setup_phases=phases,
                   live_rays=rays,
                   triangles=tris, capture_launches=r.capture_launches,
                   kept=kept)
    return r, state, prog, arrays


def frame_loop(r, state, dt, in_flight, device, until, count=None,
               on_frame=None):
    """Issue ``step_n(state, 1)`` frames while ``until()`` holds (or
    ``count`` frames), at most ``in_flight`` outstanding.  Returns
    (state, last frame, frames, host seconds inside step_n, events);
    on_frame(i, before, after, frame) sees each frame as issued."""
    pending, events = deque(), []
    host, i, frame = 0.0, 0, None
    while (i < count) if count is not None else until():
        if len(pending) >= in_flight:
            pending.popleft().synchronize()
        t = time.perf_counter()
        before = state
        state, frame = r.step_n(state, 1, dt=dt)
        host += time.perf_counter() - t
        ev = event(device)
        ev.record()
        pending.append(ev)
        events.append(ev)
        if on_frame is not None:
            on_frame(i, before, state, frame)
        i += 1
    return state, frame, i, host, events


def window(r, state, prog: Program, traffic, draw: Draw, seconds, device):
    """The measured window: fills prog's frames, wall, intervals and host
    time, and keeps the mid frame and the last for the comparison."""
    dt, in_flight = float(traffic["dt"]), int(traffic["frames_in_flight"])
    keep = {}

    def on_frame(i, before, after, frame):
        if i == draw.mid:
            keep["mid"] = Kept(done=2 + i, before=before.history,
                               history=after.history, frame=frame)
        keep["last"] = (i, before.history, after.history, frame)

    start = event(device)
    start.record()
    t0 = time.perf_counter()
    state, frame, n, host, events = frame_loop(
        r, state, dt, in_flight, device,
        until=lambda: time.perf_counter() - t0 < seconds, on_frame=on_frame)
    sync(device)
    frame.cpu()                       # the last frame, read on the host
    prog.wall_s = time.perf_counter() - t0
    prog.frames, prog.host_s = n, host
    marks = [start] + events
    prog.intervals_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    i, before, after, last = keep.pop("last")
    if "mid" in keep:
        prog.kept.append(keep["mid"])
    prog.kept.append(Kept(done=2 + i, before=before, history=after,
                          frame=last))
    return state
