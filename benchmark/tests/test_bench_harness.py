"""The harness: BENCHMARK.json against the contract, the roofline counts'
arithmetic, the readers, the result line's keys, files found by name,
and the refusals."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

import devtrace
import run
import spec
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert set(limits) == {"frame_mae", "history_rel"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert spec.reader("metrics", m["name"]).UNIT == m["unit"]
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert (BENCH / "roofline" / f"{kernel}.py").exists()
    for m in b["end_to_end"]:
        assert (BENCH / "e2e" / f"{m['name']}.py").exists()


def _trace(**over):
    t = dict(frames=2, wall_s=0.05, device_ops=[], busy_s=0.0,
             host_ms_per_frame=1.5,
             live_rays={"primary": 1000, "reflection": 100},
             triangles={"ground": 12, "model": 1280}, width=40, height=25,
             peaks={"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13},
             roofline=lambda k: spec.reader("roofline", k))
    t.update(over)
    return devtrace.Trace(**t)


def test_roofline_counts():
    t = _trace()
    k1, k2, k3 = (spec.reader("roofline", k) for k in ("k1", "k2", "k3"))
    assert k1.bytes_per_frame(t) == 1100 * (32 + 20) + 2 * 1292 * 36
    assert k1.flops_per_frame(t) == 1100 * 54
    assert k2.bytes_per_frame(t) == 2 * 1000 * 48
    assert k2.flops_per_frame(t) == 2 * 1000 * (33 * 32 + 3)
    assert k3.flops_per_frame(t) == 2 * 1000 * (33 * 23 + 3)
    frame = spec.reader("roofline", "frame")
    assert frame.bytes_per_frame(t) == (k1.bytes_per_frame(t)
                                        + k2.bytes_per_frame(t) + 1000 * 60)
    t3 = _trace(live_rays={"primary": 1000, "reflection": 100,
                           "diffuse": 50})
    assert frame.flops_per_frame(t3) == sum(
        k.flops_per_frame(t3) for k in (k1, k2, k3))


def test_busy_union_and_the_readers():
    ops = [("trace_instanced_kernel", 0.0, 1000.0),
           ("gemv2N_kernel", 500.0, 3000.0),
           ("reflection_pass_kernel", 4000.0, 5000.0),
           ("trace_instanced_kernel", 10000.0, 11000.0)]
    busy = devtrace.union_s((a, b) for _, a, b in ops)
    assert busy == pytest.approx(5e-3)
    t = _trace(device_ops=ops, busy_s=busy, wall_s=0.02)
    read = {m: spec.reader("metrics", m).read(t) for m in (
        "device_busy_ms", "device_idle_share", "glue_device_ms",
        "device_ops_per_frame", "k1_device_ms", "filter_device_ms",
        "k1_roofline", "k2_roofline", "k3_roofline", "host_ms_per_frame")}
    assert read["device_busy_ms"] == pytest.approx(2.5)
    assert read["device_idle_share"] == pytest.approx(75.0)
    assert read["glue_device_ms"] == pytest.approx(2.5 - 1.5)
    assert read["device_ops_per_frame"] == 2.0
    assert read["k1_device_ms"] == pytest.approx(1.0)
    assert read["filter_device_ms"] == pytest.approx(0.5)
    assert read["k3_roofline"] is None          # K3 did not run
    least = max((1100 * 52 + 2 * 1292 * 36) / 3.35e12, 1100 * 54 / 6.7e13)
    assert read["k1_roofline"] == pytest.approx(100 * least / 1e-3)
    assert read["host_ms_per_frame"] == 1.5
    gaps = devtrace.idle_gaps(ops, [("cudaGraphLaunch", 3100.0, 3900.0)])
    assert gaps[0] == ("(no host op)", pytest.approx(5e-3))
    assert gaps[1] == ("cudaGraphLaunch", pytest.approx(1e-3))


def test_tile_mae_reads_the_worst_tile_and_counts_where_limited():
    import judge

    ref = torch.rand(36, 64, 3)
    frame = ref.clone()
    frame[4:8, 8:12] += 0.5                     # one whole 4x4 tile
    hist = torch.rand(36, 64, 4).half()
    g = judge.gaps(frame, hist, ref, hist.clone())
    assert g["tile_mae"] == pytest.approx(0.5)
    assert g["frame_mae"] == pytest.approx(0.5 / 144)
    assert g["history_rel"] == 0.0
    limits = {"frame_mae": 1e-2, "history_rel": 1e-2}
    assert judge.verdict(g, limits)
    assert not judge.verdict(g, dict(limits, tile_mae=0.1))


def test_nothing_reads_out_of_an_empty_trace():
    t = _trace()
    for m in bench()["per_layer"]:
        if m["name"] != "host_ms_per_frame":
            assert spec.reader("metrics", m["name"]).read(t) is None


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contracts_keys_and_checks_last(tiny_cell, trace):
    cell = tiny_cell("bunny-720p.anim-m1", width=32, height=18, level=2)
    out = run.run(cell, 2 ** 31 + 5, 0.2, trace, torch.device("cpu"),
                  log=lambda s: None, trace_frames=4)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    assert set(out["checks"]) == {"frame_mae", "history_rel"}
    assert out["device"]["count"] == 1
    json.dumps(out)


def _copy_tree(dst, with_program=True):
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    if with_program:
        (dst / "raytracedggx_tpu_torch").symlink_to(
            ROOT / "raytracedggx_tpu_torch")


NEW_CELL = """
import json, sys, torch
sys.path[:0] = ["benchmark", "."]
import run, spec
cell = spec.find_cell("tiny-2.still")
out = run.run(cell, 3, 0.2, True, torch.device("cpu"), log=lambda s: None,
              trace_frames=4)
print(json.dumps(out["metrics"]))
"""


def test_new_files_are_found_by_name_with_no_edit(tmp_path):
    _copy_tree(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "bunny-720p.json").read_text())
    cfg.update(name="tiny-2", width=32, height=18, model_level=2,
               model_triangles=320)
    (b / "configs" / "tiny-2.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "anim-m1.json").read_text())
    mix.update(name="still", dt=0.0)
    (b / "traffic" / "still.json").write_text(json.dumps(mix))
    (b / "metrics" / "frames_traced.py").write_text(
        'UNIT = "frames"\nMOVES = "frame_ms"\n\n\n'
        'def read(t):\n    return float(t.frames)\n')
    (b / "limits" / "tiny-2.still.json").write_text(
        (b / "limits" / "bunny-720p.anim-m1.json").read_text())
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_json["workloads"].append({
        "name": "tiny-2.still", "config": "tiny-2", "traffic": "still",
        "chips": 1, "why": "a test"})
    spec_json["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "frame loop",
        "moves": "frame_ms", "workloads": ["tiny-2.still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))
    res = subprocess.run([sys.executable, "-c", NEW_CELL], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert metrics["frames_traced"]["value"] == 4.0


ARGS = ["--workload", "bunny-720p.anim-m1", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _no_result(res):
    assert res.returncode != 0
    assert not [ln for ln in res.stdout.splitlines()
                if ln.startswith("{")]


def test_refuses_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    res = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    _no_result(res)
    assert "no CUDA device" in res.stderr


def test_refuses_with_only_the_benchmarks_files(tmp_path):
    _copy_tree(tmp_path, with_program=False)
    res = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    _no_result(res)


def test_unknown_workload_is_an_error():
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell")


def _cell_with(tmp_path, kind, key, value):
    """A copy of the tree whose bunny cell has ``key`` set to ``value``
    in its configuration, traffic mix, limits or workload entry (``value``
    None: the key left out)."""
    _copy_tree(tmp_path)
    b = tmp_path / "benchmark"
    if kind == "workload":
        path = tmp_path / "BENCHMARK.json"
        data = json.loads(path.read_text())
        entry = next(w for w in data["workloads"]
                     if w["name"] == "bunny-720p.anim-m1")
    else:
        path = b / kind / {"configs": "bunny-720p.json",
                           "traffic": "anim-m1.json",
                           "limits": "bunny-720p.anim-m1.json"}[kind]
        data = entry = json.loads(path.read_text())
    if value is None:
        del entry[key]
    else:
        entry[key] = value
    path.write_text(json.dumps(data))
    return b


REFUSED = [("traffic", "entry", "step"),
           ("traffic", "entry", "ShardedRenderer.step_n"),
           ("traffic", "entry", None),
           ("traffic", "burst", 4),
           ("configs", "instances", 8),
           ("configs", "instances", "2"),
           ("configs", "extra_instances", [[0.0, 0.0, -2.5, 0.6]]),
           ("configs", "extra_instances", [[0.0, 0.0, 0.6]]),
           ("configs", "extra_instances", [[0.0, 0.0, -2.5, "0.6"]]),
           ("configs", "extra_instances", [[0.0, float("nan"), 0.0, 0.6]]),
           ("configs", "extra_instances", [[0.0, 0.0, -2.5, 0.0]]),
           ("configs", "extra_instances", [[0.0, 0.0, -2.5, -0.6]]),
           ("configs", "extra_instances", {"0": [0.0, 0.0, -2.5, 0.6]}),
           ("configs", "spp", 4),
           ("configs", "tone_map", False),
           ("configs", "mesh", "dragon.obj"),
           ("configs", "probe", "rnl_cross.dds"),
           ("configs", "model_tessellation", "loop"),
           ("configs", "model_triangles", 100000),
           ("configs", "precision", "bfloat16"),
           ("configs", "width", 1280.0),
           ("configs", "msaa", 4),
           ("limits", "history_rel", None),
           ("limits", "frame_max", 0.1),
           ("workload", "chips", 4)]


@pytest.mark.parametrize("kind,key,value", REFUSED)
def test_what_the_harness_does_not_implement_is_refused(tmp_path, kind,
                                                       key, value):
    b = _cell_with(tmp_path, kind, key, value)
    with pytest.raises(spec.Refused, match=key):
        spec.find_cell("bunny-720p.anim-m1", root=tmp_path, here=b)


def test_a_layout_that_gives_the_count_is_accepted(tmp_path):
    from conftest import EXTRA

    b = _cell_with(tmp_path, "configs", "extra_instances", EXTRA)
    path = b / "configs" / "bunny-720p.json"
    cfg = json.loads(path.read_text())
    cfg["instances"] = 2 + len(EXTRA)
    path.write_text(json.dumps(cfg))
    cell = spec.find_cell("bunny-720p.anim-m1", root=tmp_path, here=b)
    assert spec.extra_instances(cell.config) == tuple(map(tuple, EXTRA))
    assert spec.extra_instances(spec.find_cell("bunny-720p.anim-m1")
                                .config) == ()


def test_an_unknown_entry_prints_no_result(tmp_path):
    _cell_with(tmp_path, "traffic", "entry", "step")
    res = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    _no_result(res)
    assert "entry 'step' is not implemented" in res.stderr


def test_the_program_must_build_what_the_configuration_states(tiny_cell):
    from harness import Draw, set_up

    cell = tiny_cell()
    cell.config["model_triangles"] += 1          # as a wrong level would
    with pytest.raises(spec.Refused, match="model_triangles"):
        set_up(cell.config, cell.traffic, Draw.of(1), torch.device("cpu"),
               0.0)
