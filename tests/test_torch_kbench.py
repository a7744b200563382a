"""The kbench port (raytracedggx_tpu_torch/scripts/kbench.py) as a CPU
rehearsal: a tiny resolution and a coarse stand-in, the plain versions in
place of the kernels.  It must run its variants, print their lines and
exit 0; a failed variant must not leave the exit code 0; and without
``--device cpu`` it refuses to run where there is no card.  kpair's
pairing runs here the same way."""

import os
import subprocess
import sys

import pytest
import torch

from raytracedggx_tpu_torch.scripts import kbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(KB_RES="64x36", KB_SUBDIV="3")


def test_kbench_cpu_rehearsal_runs_two_variants():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ENV)
    res = subprocess.run(
        [sys.executable, "-m", "raytracedggx_tpu_torch.scripts.kbench", "1",
         "stats_l16", "recip_l64", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("rays: primary 2304, reflection live ")
    stats = [ln for ln in lines if ln.startswith("stats_l16 ")]
    assert len(stats) == 2 and "nodes/ray" in stats[0]
    assert "warp-max nodes" in stats[1] and " refl " in stats[1]
    timed = [ln for ln in lines if ln.startswith("recip_l64 ")]
    assert len(timed) == 1 and "reflection" in timed[0]
    assert "parity" in timed[0] and "MISMATCH" not in timed[0]
    assert "FAILED" not in res.stdout


def test_kbench_failed_variant_exits_nonzero(monkeypatch, capsys):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    run = kbench.Bench.run

    def flaky(self, name, kw, frames, parity=True):
        if name == "npop1":
            raise RuntimeError("launch refused")
        return run(self, name, kw, frames, parity)

    monkeypatch.setattr(kbench.Bench, "run", flaky)
    assert kbench.main(["1", "npop1", "alldead", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "npop1        FAILED: RuntimeError" in out
    assert "alldead      launch+prep floor" in out       # the rest still ran


def test_kbench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        kbench.main(["1", "base"])
    with pytest.raises(SystemExit):
        kbench.main(["1", "no_such_variant", "--device", "cpu"])


def test_kpair_pairs_libraries_on_the_cpu(monkeypatch):
    """kpair's rounds on the CPU, where every launch takes the plain
    version whatever library it is routed through: one median per
    library, outputs equal, and only K6a / K6b rows accepted."""
    from raytracedggx_tpu_torch.ops.lab import fused_lab
    from raytracedggx_tpu_torch.scripts import kpair

    monkeypatch.setattr(fused_lab, "load_library", fused_lab.load_library)
    bench = kbench.Bench("cpu", 64, 36, 3)
    ms, same = kpair.pair(bench, kbench.VARIANT_KW["ls_lean"],
                          ["a", "b", "c"], bench.o_r, bench.d_r, bench.t_r,
                          kbench.T_MIN_REFL, 2)
    assert same and len(ms) == 3 and min(ms) > 0
    with pytest.raises(SystemExit, match="not a K6a / K6b row"):
        kpair.main(["2", ".", "--variants", "ls", "mxu32"])
