"""Profiling hooks: the PIX-marker / GPU-timestamp analog.

Counterpart of raytracedggx_tpu/engine/profiler.py.  ``trace_frames``
records a ``torch.profiler`` trace (CPU and, on a CUDA machine, device
activity) of the frames rendered inside it and writes it as a Chrome
trace (``trace.json``, viewable in Perfetto or chrome://tracing).  The
frame's stage marks and host spans (``engine.spans``) are in it;
``spans.stage_ms(spans.mark_events(run.events))`` gives each stage's ms
per frame.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from types import SimpleNamespace

import torch


@contextlib.contextmanager
def trace_frames(logdir: str | None = None):
    """Profile the block; write ``<logdir>/trace.json`` on leaving it.
    logdir defaults to ``rtggx-trace`` under the temporary directory.
    Yields a namespace: ``logdir``, and ``events``, the profiler's events
    once the block is left."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rtggx-trace")
    os.makedirs(logdir, exist_ok=True)
    run = SimpleNamespace(logdir=logdir, events=None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield run
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    run.events = prof.events()
