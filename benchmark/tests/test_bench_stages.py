"""The stage readers (``stages.py``, ``metrics/*_stage_ms.py``),
``unstaged_device_ms`` and the K1 counters' readers on synthetic traces:
marks across frames, a frame without the diffuse mark, a stretch without
marks, and device operations that overlap."""

import pytest

import devtrace
import spec
import stages

STAGES = ("refit", "primary", "reflection", "diffuse", "spatial", "taa",
          "tonemap")


def _trace(device_ops, frames, **over):
    t = dict(frames=frames, wall_s=0.05, device_ops=device_ops,
             busy_s=devtrace.union_s((a, b) for _, a, b in device_ops),
             host_ms_per_frame=1.5,
             live_rays={"primary": 1000, "reflection": 600},
             triangles={"ground": 12, "model": 1280}, width=40, height=25,
             peaks={"hbm_bytes_per_s": 3.35e12,
                    "fp32_flops_per_s": 6.7e13})
    t.update(over)
    return devtrace.Trace(**t)


def _frame(t0, stage_us, glue="void gemv2N_kernel<int, float>"):
    """One frame's device ops from t0 (us): a 2 us mark at each stage's
    start (the names as a CUDA trace gives them), then that stage's work
    until the next mark; an end mark after the last stage."""
    ops, t = [], t0
    for stage, us in stage_us:
        ops.append((f"rtggx_mark_{stage}", t, t + 2.0))
        ops.append((glue, t + 2.0, t + us))
        t += us
    ops.append(("rtggx_mark_end", t, t + 2.0))
    return ops, t + 2.0


def _reader(name):
    return spec.reader("metrics", name)


def test_stage_readers_over_frames():
    """Each stage's mean over the frames; the diffuse stage's mean counts
    the frames that skipped it as zero; the stages sum to the frames'
    refit-to-end spans."""
    a = [("refit", 100.0), ("primary", 4000.0), ("reflection", 3000.0),
         ("diffuse", 2000.0), ("spatial", 500.0), ("taa", 300.0),
         ("tonemap", 200.0)]
    b = [s for s in a if s[0] != "diffuse"]
    ops0, end0 = _frame(0.0, a)
    ops1, end1 = _frame(end0 + 50.0, b)
    t = _trace(ops0 + ops1, frames=2)
    got = {s: _reader(f"{s}_stage_ms").read(t) for s in STAGES}
    want = dict(a)
    for s in STAGES:
        scale = 0.5 if s == "diffuse" else 1.0
        assert got[s] == pytest.approx(want[s] * scale / 1e3), s
    assert sum(got.values()) == pytest.approx(
        (end0 - 2.0 + end1 - 2.0 - (end0 + 50.0)) / 2 / 1e3)


def test_diffuse_stage_is_none_when_no_frame_ran_it():
    ops, _ = _frame(0.0, [("refit", 10.0), ("primary", 20.0),
                          ("reflection", 20.0), ("spatial", 10.0),
                          ("taa", 10.0), ("tonemap", 10.0)])
    t = _trace(ops, frames=1)
    assert _reader("diffuse_stage_ms").read(t) is None
    assert _reader("taa_stage_ms").read(t) == pytest.approx(0.01)


def test_stretch_without_marks_reads_none():
    """A program without marks (the parent) reports no stage metric and
    no unstaged time; an unpaired mark makes no frame."""
    ops = [("void gemv2N_kernel", 0.0, 100.0),
           ("void vectorized_gather_kernel", 90.0, 300.0)]
    for extra in ([], [("rtggx_mark_refit", 400.0, 402.0)]):
        t = _trace(ops + extra, frames=1)
        for name in [f"{s}_stage_ms" for s in STAGES] + [
                "unstaged_device_ms"]:
            assert _reader(name).read(t) is None, name


def test_unstaged_time_is_busy_outside_the_frames():
    """Overlapping device operations count once; work before the refit
    mark and after the end mark is unstaged, work inside is not."""
    stage_us = [(s, 100.0) for s in STAGES if s != "diffuse"]
    ops, end = _frame(1000.0, stage_us)
    before = [("Memcpy HtoD", 0.0, 300.0), ("Memcpy DtoD", 200.0, 500.0)]
    after = [("Memcpy DtoD", end + 10.0, end + 60.0),
             ("elementwise_kernel", end + 40.0, end + 90.0),
             # overlaps the end mark: only the part after it is outside
             ("clone", end - 1.0, end + 5.0)]
    t = _trace(before + ops + after, frames=1)
    want_us = 500.0 + 80.0 + 5.0
    got = _reader("unstaged_device_ms").read(t)
    assert got == pytest.approx(want_us / 1e3)
    # busy = the frame's span + what lies outside it
    assert t.busy_s * 1e3 == pytest.approx(got + (end - 1000.0) / 1e3)


def test_marks_are_named_as_a_trace_names_them():
    """A mark kernel is found with or without an argument list in its
    name; unknown stages and other kernels are not marks."""
    ops = [("rtggx_mark_refit()", 0.0, 1.0), ("rtggx_mark_bogus", 2.0, 3.0),
           ("trace_instanced_kernel<0>", 3.0, 9.0),
           ("rtggx_mark_end", 10.0, 11.0)]
    assert [m[0] for m in stages.marks(ops)] == ["refit", "end"]
    assert stages.windows(ops) == [(0.0, 11.0)]


@pytest.mark.parametrize("name,key", [("k1_box_tests_per_ray",
                                       "k1_box_tests"),
                                      ("k1_tri_tests_per_ray",
                                       "k1_tri_tests")])
def test_k1_readers_divide_by_frames_and_live_rays(monkeypatch, name, key):
    """Tests over the frames run, per live ray; None when the program
    counted none (the CPU's plain K1) or has no counters (the parent)."""
    import sys

    from raytracedggx_tpu_torch import engine
    from raytracedggx_tpu_torch.engine import spans

    t = _trace([], frames=1)
    fake = {"k1_box_tests": [0, 0, 0], "k1_tri_tests": [0, 0, 0],
            "frames": 4}
    monkeypatch.setattr(spans, "counts", lambda: dict(fake))
    assert _reader(name).read(t) is None
    fake[key] = [16000, 4800, 0]
    assert _reader(name).read(t) == pytest.approx(20800 / 4 / 1600)
    monkeypatch.delattr(engine, "spans")
    monkeypatch.setitem(sys.modules, "raytracedggx_tpu_torch.engine.spans",
                        None)
    assert _reader(name).read(t) is None
