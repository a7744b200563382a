"""Readings for the comparison's limits, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 ... [--control-seeds 4 5 6] [--out <file.jsonl>]

For each seed: a run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the kept frames), then the comparison of the
program's frames with the reference: the lower reading.  For each
control seed besides: the reference computed with TF32 matrix products
(``reference.frame.TF32``) put in the program's place on the same kept
inputs, judged against the float32 reference: the upper reading.  One
JSON line per reading, to standard output and to ``--out``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def readings(cell, seed, seconds, device, control: bool):
    import torch

    import judge
    from harness import Draw, Kept, set_up, window
    from reference.frame import TF32

    draw = Draw.of(seed)
    r, state, prog, arrays = set_up(cell.config, cell.traffic, draw, device,
                                    time.time())
    window(r, state, prog, cell.traffic, draw, seconds, device)
    kept = prog.kept
    del r, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dt = float(cell.traffic["dt"])
    ref = judge.reference_for(cell.config, cell.traffic, arrays, device)
    t = time.time()
    ref_out = judge.reference_outputs(ref, kept, draw, dt)
    ref_s = time.time() - t
    out = [{"seed": seed, "side": "program", "frames": prog.frames,
            "reference_s": ref_s,
            **judge.compare(kept, ref_out)[0]}]
    if control:
        ctrl = judge.reference_outputs(ref, kept, draw, dt, control=TF32())
        as_program = [Kept(done=k.done, before=k.before, history=h, frame=f)
                      for k, (h, f) in zip(kept, ctrl)]
        out.append({"seed": seed, "side": "control_tf32",
                    **judge.compare(as_program, ref_out)[0]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, str(run.ROOT))
    import spec

    cell = spec.find_cell(a.workload)
    device = run.require_devices(cell.chips)
    sink = open(a.out, "a") if a.out else None
    try:
        for seed in dict.fromkeys(a.seeds + a.control_seeds):
            for line in readings(cell, seed, a.seconds, device,
                                 seed in a.control_seeds):
                line.update(workload=a.workload, card=run.card())
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
