"""The frame's measurement inside the program: stage marks, K1's work
counters and the frame loop's host spans.

- **Stage marks.**  ``mark(stage, device)`` marks where a stage of the
  frame begins, in ``STAGES``' order (refit, primary, reflection, the
  diffuse wave where its gate is open, spatial, taa, tonemap, then end).
  On a CUDA device it launches the stage's empty one-thread kernel,
  ``rtggx_mark_<stage>`` (``csrc/marks.cu``), on the current stream, so
  a frame captured into a CUDA graph holds its marks as kernel nodes and
  every replay shows them in a device trace.  On the CPU it records a
  zero-length ``record_function`` scope of the same name.  The
  marks are part of every frame (``Renderer.step``, ``step_n``'s
  captured frame and its warm-up, each band of ``ShardedRenderer``);
  nothing switches them off.  ``stage_ms`` turns a profiler's events
  into each stage's time per frame.
- **K1's work.**  One process-wide ``(3, K1_SLOTS, 3)`` int64 tensor per
  device (``k1_stats``): the primary, reflection and diffuse waves, each
  ``K1_SLOTS`` rows of the child-box tests, triangle tests and instance
  entries (``K1_COUNTS``) that K1 adds to them, K1's block b to row
  b % K1_SLOTS, so that its warps' atomics do not all meet on the same
  addresses (``"wide"`` traversal, CUDA only; K1's plain version on CPU
  tensors adds nothing).  An instance entry is one instance's
  object-space subtree that a ray walks (K1 pushes its top-tree child).
  A captured frame bakes its address in, so every replay adds to it.
  ``count_frames`` counts the frames the program ran: each ``step``,
  each eager warm-up frame of a capture and each graph replay.
  ``counts`` reads both.
- **Host spans.**  ``span(name)`` (and the decorator ``spanned``) is a
  ``record_function`` scope named ``rtggx.<phase>``, on the same clock
  as a profiler's device events.

The scopes are torch's lean ``_RecordFunctionFast``: a fraction of a
microsecond when no profiler runs, where ``torch.profiler.
record_function`` takes about 12 us.
"""

from __future__ import annotations

import functools

import torch

STAGES = ("refit", "primary", "reflection", "diffuse", "spatial", "taa",
          "tonemap", "end")
WAVES = ("primary", "reflection", "diffuse")
K1_SLOTS = 128
# the columns of a row of K1's counters, under their names in counts()
K1_COUNTS = ("k1_box_tests", "k1_tri_tests", "k1_inst_entries")
MARK = "rtggx_mark_"

_k1 = {}            # device -> (len(WAVES), K1_SLOTS, 3) int64 counters
_frames = 0


def mark(stage: str, device) -> None:
    """Mark the start of ``stage`` of the frame on ``device``'s current
    stream (the module docstring)."""
    index = STAGES.index(stage)
    if device.type == "cuda":
        from ..ops.cuda_lib import check_launch, load_library, stream_handle

        err = load_library().rtggx_mark(index, stream_handle(device))
        check_launch(err, f"{MARK}{stage}")
    else:
        with _record(MARK + stage):
            pass


def span(name: str):
    """A host span ``rtggx.<name>`` (a ``record_function`` scope)."""
    return _record(f"rtggx.{name}")


def spanned(name: str):
    """Decorator: the function's calls run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _record(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def k1_stats(device) -> torch.Tensor:
    """``device``'s (3, K1_SLOTS, 3) int64 K1 counters, made zero at first
    use; make them before a frame is captured, which then adds to them."""
    device = torch.device(device)
    if device not in _k1:
        _k1[device] = torch.zeros((len(WAVES), K1_SLOTS, len(K1_COUNTS)),
                                  dtype=torch.int64, device=device)
    return _k1[device]


def count_frames(n: int = 1) -> None:
    global _frames
    _frames += n


def counts() -> dict:
    """{"k1_box_tests": [primary, reflection, diffuse], "k1_tri_tests":
    [...], "k1_inst_entries": [...], "frames": frames run}, summed over
    devices since the process started.  Reads the counters back: call it
    after the work."""
    total = torch.zeros((len(WAVES), len(K1_COUNTS)), dtype=torch.int64)
    for stats in _k1.values():
        total += stats.sum(dim=1).cpu()
    out = {name: col for name, col in zip(K1_COUNTS, total.t().tolist())}
    out["frames"] = _frames
    return out


def mark_events(events) -> list:
    """[(stage, start_us)] of the marks among a profiler's events (its
    ``events()``), in time order: the device's kernels where there are
    any, else the CPU's zero-length scopes."""
    cuda = torch.autograd.DeviceType.CUDA
    found = {True: [], False: []}
    for e in events:
        if MARK in e.name:
            stage = e.name.split(MARK, 1)[1].split("(", 1)[0]
            if stage in STAGES:
                found[e.device_type == cuda].append(
                    (e.time_range.start, stage))
    marks = found[True] or found[False]
    return [(stage, start) for start, stage in sorted(marks)]


def stage_ms(marks) -> dict:
    """{stage: mean ms per frame from its mark to the next mark} over
    the frames that ``marks`` (``mark_events``) hold, a frame running
    from a refit mark to the next end mark; a stage that no frame ran
    is left out."""
    total, frames, frame = {}, 0, None
    for stage, start in marks:
        if stage == "refit":
            frame = [(stage, start)]
        elif frame is not None:
            frame.append((stage, start))
            if stage == "end":
                frames += 1
                for (s, a), (_, b) in zip(frame, frame[1:]):
                    total[s] = total.get(s, 0.0) + (b - a) / 1e3
                frame = None
    return {s: total[s] / frames for s in STAGES if s in total}
