"""Paired timing of the kernel lab's K6a / K6b rows across builds of the
kernel library, interleaved in one process.

kbench prices a variant once per process, and on the H100 a K6b row moves
10-20% between two kbench processes of the same code, as much as a
redesign changes it.  kpair takes checkouts of the port (this one and, say,
a parent unpacked with ``git archive``), builds each one's kernel library
in its own tree with its own ``cuda_lib``, and launches each variant on
kbench's two ray sets through every library in turn, ``frames`` rounds,
each round starting at the next library, so that all of them see the same
clocks.  The wrapper is this checkout's, so the libraries must share the C
interface of ``rtggx_trace_lab``.  Each library's t, prim, inst and
per-ray node and leaf visits must equal the first one's bit for bit (the
walk and its arithmetic are the same); a difference is reported and the
script exits non-zero.

    python -m raytracedggx_tpu_torch.scripts.kpair FRAMES TREE [TREE...]
        [--variants NAME...]

TREE is a directory holding ``raytracedggx_tpu_torch/``; the variants
default to the four K6b rows.  Prints, per variant and set, each tree's
median ms of its launches (CUDA events around each one) and its ratio to
the first tree's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.lab import fused_lab
from .kbench import T_MIN_REFL, VARIANT_KW, Bench, card_line, kernel_of

K6B_ROWS = ("ls", "ls_lean", "ls_lean_l16", "ls_lean_smem16")


def tree_library(tree: str) -> ctypes.CDLL:
    """The kernel library of the checkout at ``tree``, built by its own
    ``cuda_lib`` in a child process, with this checkout's signature of
    ``rtggx_trace_lab``."""
    res = subprocess.run(
        [sys.executable, "-c", "from raytracedggx_tpu_torch.ops import "
         "cuda_lib; print(cuda_lib.build()[0])"], cwd=tree,
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: build failed\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(res.stdout.strip().splitlines()[-1])
    fn = lib.rtggx_trace_lab
    fn.argtypes = list(cuda_lib.SIGNATURES["rtggx_trace_lab"])
    fn.restype = ctypes.c_int
    return lib


def use(lib) -> None:
    """Route the lab wrappers' launches through ``lib``."""
    fused_lab.load_library = lambda: lib


def launch_ms(fn, device) -> float:
    """Milliseconds of one fn(): CUDA events on the card, the host clock
    on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def pair(bench, kw, libs, o, d, t_max, t_min, frames):
    """(median ms per library, whether every library's t, prim, inst and
    visits equal the first one's)."""
    outs = []
    for lib in libs:
        use(lib)
        outs.append(bench.launch(kw, o, d, t_max, stats=True, t_min=t_min))
    same = all(torch.equal(out[i], outs[0][i]) for out in outs[1:]
               for i in (0, 4, 5, 6))
    times = [[] for _ in libs]
    for f in range(frames):
        for k in range(len(libs)):
            i = (f + k) % len(libs)
            use(libs[i])
            times[i].append(launch_ms(
                lambda: bench.launch(kw, o, d, t_max, t_min=t_min),
                bench.device))
    return [float(np.median(t)) for t in times], same


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    names = list(K6B_ROWS)
    if "--variants" in argv:
        i = argv.index("--variants")
        names = argv[i + 1:]
        del argv[i:]
    if len(argv) < 2:
        raise SystemExit(__doc__)
    frames, trees = int(argv[0]), argv[1:]
    bad = [n for n in names
           if n not in VARIANT_KW or kernel_of(VARIANT_KW[n]) not in
           ("K6a", "K6b")]
    if bad:
        raise SystemExit(f"not a K6a / K6b row of kbench: {bad}")
    if not torch.cuda.is_available():
        raise SystemExit("kpair needs a CUDA device")
    print(card_line(), flush=True)
    libs = [tree_library(os.path.abspath(t)) for t in trees]
    W, H = (int(v) for v in os.environ.get("KB_RES", "1280x720").split("x"))
    bench = Bench("cuda", W, H, int(os.environ.get("KB_SUBDIV", "6")))
    sets = (("primary", bench.o_p, bench.d_p, bench.t_p, 0.0),
            ("reflection", bench.o_r, bench.d_r, bench.t_r, T_MIN_REFL))
    failed = False
    for name in names:
        for label, o, d, t_max, t_min in sets:
            ms, same = pair(bench, VARIANT_KW[name], libs, o, d, t_max,
                            t_min, frames)
            cells = ", ".join(f"{t} {m:.4f} ms ({m / ms[0]:.3f}x)"
                              for t, m in zip(trees, ms))
            print(f"{name:14s} {label:10s} {cells}"
                  f"{'' if same else '  OUTPUTS DIFFER'}", flush=True)
            failed |= not same
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
