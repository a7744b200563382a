"""The comparison that decides ``correct``: the frames the program kept,
worked out again by the plain reference (``reference/frame.py``).

The reference follows the program step by step from the program's own
TAA history, which carries every earlier frame: a kept window frame is
rendered by the reference from the history the program started it with,
and the angle, frame counter and previous WVPs the reference works out
itself from the seed's start.  The start is checked on its own: the
first two frames (the eager warm-up and the first captured frame) from
a zero history, the reference on its own chain.

Three numbers, each the worst over the kept frames:
- ``frame_mae``: the mean absolute difference of the tone-mapped frame
  (every pixel and channel);
- ``history_rel``: the summed absolute difference of the f16 history
  over the reference's summed absolute history;
- ``tile_mae``: the frame's mean absolute difference in the worst tile
  of a 16 x 9 grid over it: a fault confined to one region, such as one
  of several model instances drawn wrong, which the whole frame's mean
  dilutes below its limit.
Every cell's limits give the first two; ``tile_mae`` is compared where
the cell's limits give it (``spec.NUMBERS``).
"""

from __future__ import annotations

import math

import numpy as np
import torch.nn.functional as F

from reference.frame import ReferenceRenderer, State, advance
from spec import NUMBERS, extra_instances

TILES = (9, 16)          # tile_mae's grid: rows, columns


def reference_for(config, traffic, arrays, device):
    return ReferenceRenderer(
        arrays, tuple(config["model_pos_scale"]), config["width"],
        config["height"],
        metallic={int(k): float(v) for k, v in traffic["metallic"].items()},
        spatial=config["spatial"], temporal=config["temporal"],
        device=device, extra_instances=extra_instances(config))


def state_at(ref: ReferenceRenderer, draw, dt, done, history) -> State:
    """The reference's state after ``done`` frames from the start, with
    the given history (the program's): the angle advanced ``done`` times,
    the previous WVPs those of the last frame done (of angle 0 before any,
    as the renderer's start state)."""
    import torch

    angle = np.float32(draw.angle0)
    for _ in range(done):
        angle = advance(angle, dt)
    worlds = ref.scene.worlds(angle if done else 0.0)
    prev = torch.einsum("ijk,kl->ijl", worlds, ref.view_proj).to(ref.device)
    return State(history=history, prev_wvp=prev, angle=angle,
                 frame=draw.frame0 + done)


def gaps(frame, history, ref_frame, ref_history) -> dict:
    f = frame.to(ref_frame.device, dtype=ref_frame.dtype)
    h = history.to(ref_history.device).float()
    rh = ref_history.float()
    gap = (f - ref_frame).abs()
    tiles = F.adaptive_avg_pool2d(gap.mean(-1)[None, None], TILES)
    return {"frame_mae": float(gap.mean()),
            "history_rel": float((h - rh).abs().sum()
                                 / rh.abs().sum().clamp(min=1e-30)),
            "tile_mae": float(tiles.max())}


def reference_outputs(ref, kept, draw, dt, control=None):
    """[(ref history, ref frame)] for each kept frame; ``control`` a
    context manager (the TF32 mode) the reference computes under."""
    import contextlib

    out, chain = [], None
    with control if control is not None else contextlib.nullcontext():
        for k in kept:
            if k.before is None:          # the start, on its own chain
                if chain is None:
                    chain = ref.start_state(draw.angle0, draw.frame0)
                chain, frame = ref.step(chain, dt)
                out.append((chain.history, frame))
            else:
                st = state_at(ref, draw, dt, k.done,
                              k.before.to(ref.device))
                st, frame = ref.step(st, dt)
                out.append((st.history, frame))
    return out


def compare(kept, ref_out):
    """({number: worst over the kept frames}, [per kept frame numbers]);
    a NaN anywhere stays NaN."""
    worst, each = {n: 0.0 for n in NUMBERS}, []
    for k, (rh, rf) in zip(kept, ref_out):
        g = gaps(k.frame, k.history, rf, rh)
        each.append(g)
        for n, v in g.items():
            if not math.isnan(worst[n]):
                worst[n] = v if math.isnan(v) else max(worst[n], v)
    return worst, each


def verdict(numbers: dict, limits: dict) -> bool:
    """Each number the limits give within its limit."""
    return all(not math.isnan(numbers[n]) and numbers[n] <= limits[n]
               for n in limits)
