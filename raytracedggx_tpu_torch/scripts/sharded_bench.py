"""Bench of the row-band renderer (parallel/sharded.py) against the
single-device ``Renderer``: the port of the JAX package's
scripts/sharded_bench.py.

    python -m raytracedggx_tpu_torch.scripts.sharded_bench [frames]

Four bands all run on the first CUDA device, as the reference's script
ran its mesh on one TPU chip: the measured difference against the
single-device frame prices the band bookkeeping and the halo recompute
(4 bands of 180 rows with halo 32 trace 4 x 244 = 976 rows a frame
against 720), the halo exchange being a copy on the card.  Each renderer
takes one warm-up step, then ``frames`` steps (240 by default) are timed
between device syncs, the per-frame ``step`` loop of the reference's
script, in halves in the order halo 32, halo 16, single device, single
device, halo 16, halo 32 (the eager loop follows the host's speed, which
drifts within a run); one more window of 10 steps each under
torch.profiler gives the device busy ms/frame and the idle share.  The
scene is the bench's headline scene (``bench.py`` config 0: the stand-in
model, the procedural sky, unless the reference's assets are present) at
1280x720 (``RTGGX_BENCH_RES``).  It raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from ..bench import CONFIGS, _res, bench_scene, card
from ..engine import RenderConfig, Renderer
from ..parallel import ShardedRenderer, make_row_mesh

HALOS = (32, 16)
BANDS = 4


def time_steps(r, frames: int, dt: float = 1 / 60, state=None):
    """ms/frame of ``frames`` steps between device syncs, the last frame
    read on the host, after one warm-up step when no ``state`` is given.
    Returns (ms/frame, state)."""
    if state is None:
        state, frame, _ = r.step(r.init_state(), dt)
        frame.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state, frame, _ = r.step(state, dt)
    torch.cuda.synchronize()
    frame.cpu()
    return (time.perf_counter() - t0) / frames * 1e3, state


def paired(renderers: dict, frames: int):
    """{label: [ms/frame of each half]}: ``frames`` // 2 steps per half, in
    the order of ``renderers`` and back."""
    states = {k: None for k in renderers}
    ms = {k: [] for k in renderers}
    order = list(renderers)
    for label in order + order[::-1]:
        t, states[label] = time_steps(renderers[label], max(1, frames // 2),
                                      state=states[label])
        ms[label].append(t)
    return ms


def device_profile(r, frames: int = 10, dt: float = 1 / 60):
    """(device busy ms/frame, idle share, device operations per frame) of
    ``frames`` steps under torch.profiler (kprofile's measure)."""
    from .kprofile import busy_us, profiled

    box = {"state": r.step(r.init_state(), dt)[0]}

    def step():
        box["state"] = r.step(box["state"], dt)[0]

    events, wall = profiled(lambda: [step() for _ in range(frames)], 1)
    busy = busy_us(events) / 1e3
    return busy / frames, 1.0 - busy / wall, len(events) / frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=240)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sharded_bench needs a CUDA device")
    mesh = make_row_mesh(("cuda:0",) * BANDS)
    w, h = _res()
    with tempfile.TemporaryDirectory(prefix="rtggx-sharded-") as tmp:
        scene, scene_name = bench_scene(CONFIGS[0], None, tmp)
    cfg = RenderConfig(width=w, height=h)
    print(f"{BANDS} bands on cuda:0; {w}x{h}; scene {scene_name}; {card()}",
          flush=True)
    renderers = {f"sharded n={BANDS} halo={halo}": ShardedRenderer(
        scene, mesh=mesh, halo=halo, config=cfg) for halo in HALOS}
    renderers["single device"] = Renderer(scene, config=cfg, device=mesh[0])
    for label, ms in paired(renderers, args.frames).items():
        r = renderers[label]
        rows = (f"band {r.band} + 2x{r.halo} halo rows"
                if isinstance(r, ShardedRenderer) else "per-frame step")
        busy, idle, ops = device_profile(r)
        print(f"{label}: {' / '.join(f'{t:.4f}' for t in ms)} ms/frame "
              f"(halves; {rows}); device busy {busy:.4f} ms/frame, idle "
              f"share {idle:.4f}, {ops:.1f} device ops per frame "
              f"(profiler on)", flush=True)


if __name__ == "__main__":
    main()
