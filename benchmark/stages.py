"""The frame's stages in a traced stretch, read from the program's stage
marks: empty one-thread kernels named ``rtggx_mark_<stage>`` that the
program launches where each stage of its frame begins, captured with
the frame, so each replay shows them among its device operations.

A frame runs from a ``refit`` mark to the next ``end`` mark; a stage
runs from its mark's start to the next mark's start.  Reads only the
trace's device operations (``devtrace.Trace.device_ops``), so a program
without marks gives None.
"""

from __future__ import annotations

MARK = "rtggx_mark_"
STAGES = ("refit", "primary", "reflection", "diffuse", "spatial", "taa",
          "tonemap")
FIRST, END = "refit", "end"


def marks(device_ops) -> list:
    """[(stage, start_us, end_us)] of the mark kernels, in time order."""
    out = []
    for name, a, b in device_ops:
        if MARK in name:
            stage = name.split(MARK, 1)[1].split("(", 1)[0]
            if stage in STAGES or stage == END:
                out.append((a, b, stage))
    return [(stage, a, b) for a, b, stage in sorted(out)]


def frames(device_ops) -> list:
    """Each frame's marks, [(stage, start_us, end_us)] from a refit mark
    to the next end mark; marks outside such a run are left out."""
    out, frame = [], None
    for m in marks(device_ops):
        if m[0] == FIRST:
            frame = [m]
        elif frame is not None:
            frame.append(m)
            if m[0] == END:
                out.append(frame)
                frame = None
    return out


def stage_ms(t, stage: str):
    """Mean ms per frame of ``stage`` over the stretch's frames, None
    where no frame ran it (or the stretch holds no marks)."""
    runs = frames(t.device_ops)
    total, seen = 0.0, False
    for frame in runs:
        for (s, a, _), (_, b, _) in zip(frame, frame[1:]):
            if s == stage:
                total += b - a
                seen = True
    return total / 1e3 / len(runs) if seen else None


def windows(device_ops) -> list:
    """[(start_us, end_us)] of each frame, from its refit mark's start to
    its end mark's end."""
    return [(f[0][1], f[-1][2]) for f in frames(device_ops)]


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def outside_s(device_ops, spans) -> float:
    """Seconds of the union of the device operations' intervals that lie
    outside every (start_us, end_us) span."""
    busy = _merged((a, b) for _, a, b in device_ops)
    cover = _merged(spans)
    inside, j = 0.0, 0
    for a, b in busy:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            inside += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return (sum(b - a for a, b in busy) - inside) / 1e6
