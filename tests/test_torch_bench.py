"""The port's bench (raytracedggx_tpu_torch/bench.py) as a CPU rehearsal:
``_run_config`` in this process at 32x18 on an 80-triangle OBJ with
``RTGGX_BENCH_DEVICE=cpu`` (the JSON keys, the metric names, the live-ray
count against the warm-up frame's G-buffers); the parent process without
a CUDA device and without that variable (the sentinel line, exit 0: the
child never renders on the CPU unasked); and the parent's handling of
the child's output with ``--all-configs``."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from raytracedggx_tpu_torch import bench
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.scene import Scene
from raytracedggx_tpu_torch.scripts.standin import model_mesh, write_obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "note"}


@pytest.fixture
def small_obj(tmp_path):
    path = str(tmp_path / "model.obj")
    write_obj(path, model_mesh(1))
    return path


@pytest.fixture
def cpu_bench(monkeypatch):
    monkeypatch.setenv("RTGGX_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("RTGGX_BENCH_RES", "32x18")
    monkeypatch.setenv("RTGGX_BENCH_FRAMES", "2")
    for k in ("RTGGX_BENCH_TRAVERSAL", "RTGGX_BENCH_CONFIG"):
        monkeypatch.delenv(k, raising=False)


def _warmup_rays(obj, width, height, metallic=None, dt=1 / 60):
    """Live rays of one step on the same scene, counted here."""
    scene = Scene.create(obj, pos_scale=bench.STANDIN_POS)
    r = Renderer(scene, config=RenderConfig(width=width, height=height),
                 device="cpu")
    if metallic is not None:
        for mesh_idx in (0, 1):
            r.set_metallic(mesh_idx, metallic)
    _, _, aux = r.step(r.init_state(), dt)
    hit = aux["normal"][..., 3].numpy() > 0.5
    metal = aux["rough_metal"][..., 1].numpy()
    return width * height + int(hit.sum()) + int((hit & (metal < 1)).sum())


def _check_record(rec, metric, rays):
    assert set(rec) == KEYS
    assert rec["metric"] == metric
    assert rec["unit"] == "Mrays/s"
    note = rec["note"]
    got = int(re.search(r"live rays/frame (\d+)", note).group(1))
    assert got == rays
    ms = float(re.search(r": ([0-9.]+) ms/frame", note).group(1))
    want = rays / ms / 1e3
    assert abs(rec["value"] - want) <= 5e-4 + 1e-3 * want
    assert abs(rec["vs_baseline"] - rec["value"] / 373.248) <= 1e-5
    assert "device cpu" in note and "launches K1 0 K2 0 K3 0" in note
    json.dumps(rec)


def test_run_config_headline(cpu_bench, small_obj):
    rec = bench._run_config(0, model_path=small_obj)
    _check_record(rec, "mrays_per_s_per_chip_e2e_32x18",
                  _warmup_rays(small_obj, 32, 18))
    assert "headline_bunny_full" in rec["note"]
    assert "model.obj (80 triangles, stand-in for bunny.obj)" in rec["note"]
    assert "procedural sky" in rec["note"]


def test_run_config_three_wave_metric(cpu_bench, small_obj, monkeypatch):
    """Config 6 (metallic 0.5: the diffuse wave is live) at this test's
    size: the metric gains _cfg6 and its rays count the diffuse wave."""
    monkeypatch.setitem(bench.CONFIGS[6], "res", (32, 18))
    rec = bench._run_config(6, model_path=small_obj)
    rays = _warmup_rays(small_obj, 32, 18, metallic=0.5)
    _check_record(rec, "mrays_per_s_per_chip_e2e_32x18_cfg6", rays)
    diff = int(re.search(r"diffuse (\d+)", rec["note"]).group(1))
    assert diff > 0


def test_parent_without_cuda_prints_the_sentinel():
    """No CUDA device and no RTGGX_BENCH_DEVICE: the child raises, the
    parent prints value 0 with the child's rc and exits 0."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RTGGX_BENCH")}
    env.update(CUDA_VISIBLE_DEVICES="", RTGGX_BENCH_TIMEOUT="300")
    res = subprocess.run(
        [sys.executable, "-m", "raytracedggx_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=320)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "mrays_per_s_per_chip_e2e_1280x720"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "bench child rc=1" in rec["note"]
    assert "no CUDA device" in rec["note"]


def test_parent_imports_no_torch():
    probe = ("import sys; import raytracedggx_tpu_torch.bench; "
             "print('torch' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "False", res.stderr


def _line(cfg_id, value=1.5):
    return json.dumps({"metric": f"mrays_per_s_per_chip_e2e_1280x720_cfg"
                       f"{cfg_id}", "value": value, "unit": "Mrays/s",
                       "vs_baseline": 0.1, "note": "x"})


@pytest.mark.parametrize("all_cfgs, rc, stdout, want", [
    # every config's line, the child's other output dropped
    (True, 0, ["building", _line(1), "[1, 2]", _line(2), "{}", _line(3),
               _line(4), "null", _line(5), _line(6)],
     [1, 2, 3, 4, 5, 6]),
    # the child failed after two configs: their lines, then the sentinel
    (True, 1, [_line(1), _line(2)], [1, 2, 0]),
    (True, 0, ["nothing"], [0]),
    # one config: the last metric line, or the sentinel on a failure
    (False, 0, ["x", _line(0, 2.0), _line(0, 3.0)], [3.0]),
    (False, 3, [_line(0, 2.0)], [0]),
])
def test_parent_filters_the_child_lines(monkeypatch, capsys, all_cfgs, rc,
                                        stdout, want):
    def fake_run(cmd, **kw):
        assert cmd[1:4] == ["-m", "raytracedggx_tpu_torch.bench", "--child"]
        assert ("--all-configs" in cmd) == all_cfgs
        assert kw["cwd"] == ROOT
        return subprocess.CompletedProcess(cmd, rc, "\n".join(stdout),
                                           "Traceback\nboom")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["bench"] + (["--all-configs"]
                                                  if all_cfgs else []))
    bench.main()
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert all(set(rec) == KEYS for rec in out)
    if all_cfgs:
        got = [int(rec["metric"].split("cfg")[1]) if "cfg" in rec["metric"]
               else 0 for rec in out]
        assert got == want
    else:
        assert [rec["value"] for rec in out] == want
    if want[-1] == 0:
        assert out[-1]["value"] == 0.0
        assert f"bench child rc={rc}: Traceback | boom" in out[-1]["note"]


def test_parent_timeout_prints_the_sentinel(monkeypatch, capsys):
    def fake_run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["bench"])
    monkeypatch.setenv("RTGGX_BENCH_TIMEOUT", "7")
    bench.main()
    rec = json.loads(capsys.readouterr().out)
    assert rec["value"] == 0.0 and "timeout after 7s" in rec["note"]


def test_configs_follow_the_reference():
    """Configs 0-6 with the reference's names, sizes and knobs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert bench.NORTH_STAR_MRAYS == ref.NORTH_STAR_MRAYS
    assert sorted(bench.CONFIGS) == sorted(ref.CONFIGS)
    for k, c in ref.CONFIGS.items():
        port = {key: v for key, v in bench.CONFIGS[k].items()
                if key != "standin"}
        assert port == c, k
    assert np.isclose(bench.NORTH_STAR_MRAYS, 373.248)
