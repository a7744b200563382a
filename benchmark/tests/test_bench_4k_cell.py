"""The 4K eight-instance cell (``bunny-4k-8inst.anim-m1``) on the CPU:
its configuration is the bunny's with the size and the layout of the
port's bench config 5, the harness builds the scene it states, the
frozen reference renders that layout as the port's plain route does,
its limits give tile_mae, and the reader of K1's instance entries."""

import json
import sys

import pytest
import torch

import spec
from conftest import BENCH, ROOT

CELL = "bunny-4k-8inst.anim-m1"
# what the configuration may change from the bunny's, besides the keys
# that only describe the deployment
CHANGED = {"width", "height", "instances", "extra_instances"}


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_the_configuration_is_the_bunnys_at_4k_over_eight_instances(
        tmp_path):
    from raytracedggx_tpu_torch.bench import CONFIGS, bench_scene
    from standin import model_arrays, write_obj

    cfg, bunny = _config("bunny-4k-8inst"), _config("bunny-720p")
    differ = {k for k in set(cfg) | set(bunny)
              if cfg.get(k) != bunny.get(k)} - spec.DESCRIBES
    assert differ == CHANGED
    assert (cfg["width"], cfg["height"]) == CONFIGS[5]["res"]
    assert cfg["instances"] == 2 + CONFIGS[5]["extra"] == 8
    path = tmp_path / "m.obj"
    write_obj(path, model_arrays(1, (0.0, 0.0, 0.0)))
    scene, _ = bench_scene(CONFIGS[5], str(path), str(tmp_path))
    assert spec.extra_instances(cfg) == scene.extra_instances
    assert {"layout", "refit"} <= set(cfg["assumed"])
    entry = {c["name"]: c for c in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["configs"]}["bunny-4k-8inst"]
    assert entry["file"] == "benchmark/configs/bunny-4k-8inst.json"
    assert entry["reduced"] == cfg["reduced"] == bunny["reduced"]


def test_the_cell_passes_spec_with_tile_mae_in_its_limits():
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["name"] == "anim-m1"
    assert set(cell.limits) == {"frame_mae", "history_rel", "tile_mae"}
    assert cell.limits["tile_mae"] > 0
    names = {m["name"] for m in cell.per_layer}
    assert "k1_inst_entries_per_ray" in names
    assert "diffuse_stage_ms" not in names and "k3_roofline" not in names


def test_the_harness_builds_the_scene_the_cell_states(tiny_cell):
    """Cut to 64x36, the cell's set-up builds 8 instances whose worlds at
    the start angle are, bit for bit, those the configuration states
    (``harness.check_scene``); XF's table has a row for each."""
    from harness import Draw, build

    cell = tiny_cell(CELL)
    r, _, _ = build(cell.config, cell.traffic, Draw.of(2 ** 31 + 7),
                    torch.device("cpu"))
    assert r.scene.mesh_ids == (0,) + (1,) * 7
    assert r.scene.extra_instances == spec.extra_instances(cell.config)
    assert r.scene.worlds(0.25).shape == (8, 4, 4)


def test_reference_is_the_ports_plain_route_at_the_cells_layout(tmp_path):
    """At 64x36 and metallic 1, over the cell's own six extra instances,
    the port's "jax" traversal and the frozen reference agree bit for bit
    (the layouts of test_bench_reference, at the cell's)."""
    from test_bench_reference import _frames

    extra = spec.extra_instances(_config("bunny-4k-8inst"))
    for frame, hist, rframe, rhist in _frames(tmp_path, "jax", 1.0, extra):
        assert torch.equal(frame, rframe)
        assert torch.equal(hist, rhist)


def _trace():
    import devtrace

    return devtrace.Trace(
        frames=1, wall_s=0.05, device_ops=[], busy_s=0.0,
        host_ms_per_frame=1.5, live_rays={"primary": 1000,
                                          "reflection": 600},
        triangles={"ground": 12, "model": 1280}, width=40, height=25,
        peaks={"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13})


def test_inst_entries_reader_divides_by_frames_and_live_rays(monkeypatch):
    """Entries over the frames run, per live ray; None when the program
    counted none (the CPU's plain K1), has no such counter (the parent's
    counts() lacks the key) or no counters at all."""
    from raytracedggx_tpu_torch import engine
    from raytracedggx_tpu_torch.engine import spans

    reader = spec.reader("metrics", "k1_inst_entries_per_ray")
    assert reader.UNIT == "entries" and reader.MOVES == "frame_ms"
    t = _trace()
    fake = {"k1_box_tests": [900, 300, 0], "k1_tri_tests": [80, 40, 0],
            "k1_inst_entries": [0, 0, 0], "frames": 4}
    monkeypatch.setattr(spans, "counts", lambda: dict(fake))
    assert reader.read(t) is None
    fake["k1_inst_entries"] = [5200, 1800, 0]
    assert reader.read(t) == pytest.approx(7000 / 4 / 1600)
    del fake["k1_inst_entries"]
    assert reader.read(t) is None
    monkeypatch.delattr(engine, "spans")
    monkeypatch.setitem(sys.modules, "raytracedggx_tpu_torch.engine.spans",
                        None)
    assert reader.read(t) is None


def test_inst_entries_reader_reads_the_programs_counters(monkeypatch):
    """Through the program's own counts(): a column of K1's counters added
    to by hand is what the reader divides."""
    from raytracedggx_tpu_torch.engine import spans

    reader = spec.reader("metrics", "k1_inst_entries_per_ray")
    monkeypatch.setattr(spans, "_k1", {})
    monkeypatch.setattr(spans, "_frames", 0)
    stats = spans.k1_stats("cpu")
    stats[0, 5, spans.K1_COUNTS.index("k1_inst_entries")] = 3200
    stats[1, 9, spans.K1_COUNTS.index("k1_inst_entries")] = 800
    spans.count_frames(2)
    assert reader.read(_trace()) == pytest.approx(4000 / 2 / 1600)
    assert spans.counts()["k1_inst_entries"] == [3200, 800, 0]
