"""The frame's measurement inside the port (``engine/spans.py``): the
stage marks of every route in their fixed order, K1's work counters and
the count of frames run.

On the CPU a mark is a zero-length ``record_function`` scope, read here
from ``torch.profiler``'s host events; on the card it is a kernel of
``csrc/marks.cu``, and the tests marked ``cuda`` read it from a replay's
device events.  This file imports JAX only inside the CPU tests that
compare with the JAX package, so on a card without JAX it runs alone:

    python -m pytest -q --noconftest -m cuda tests/test_torch_spans.py
"""

import numpy as np
import pytest
import torch

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer, spans
from raytracedggx_tpu_torch.engine import renderer as t_renderer
from raytracedggx_tpu_torch.ops import fused
from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                   refit_scene_wide,
                                                   trace_scene_wide_fused)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.trace.geometry import upload_scene

W, H = 48, 32


def _scene():
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 3.0, 0.0, 1.0], np.float32))


def _renderer(device="cpu", metallic=1.0, width=W, height=H, **cfg):
    r = Renderer(_scene(), config=RenderConfig(width=width, height=height,
                                               **cfg), device=device)
    for mesh in (0, 1):
        r.set_metallic(mesh, metallic)
    return r


def _order(metallic):
    """The marks of one frame: the diffuse wave's only where it runs."""
    return [s for s in spans.STAGES if s != "diffuse" or metallic < 1.0]


def _marks(fn):
    """(fn()'s result, [stage] of the marks fn made, in time order)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, [s for s, _ in spans.mark_events(prof.events())]


@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_step_marks_the_stages_in_order(metallic):
    r = _renderer(metallic=metallic)
    _, got = _marks(lambda: r.step(r.init_state()))
    assert got == _order(metallic)


def test_a_band_marks_the_stages_in_order():
    """Each band of the row-band renderer marks its own stages; the one
    device's refit runs before the bands."""
    from raytracedggx_tpu_torch.parallel import ShardedRenderer

    r = ShardedRenderer(_scene(), mesh=("cpu",) * 2, halo=4,
                        config=RenderConfig(width=32, height=32))
    r.set_metallic(1, 0.5)
    _, got = _marks(lambda: r.step(r.init_state()))
    band = _order(0.5)[1:]
    assert got == ["refit"] + band + band


def test_frames_count_each_step_and_each_step_n_frame(monkeypatch):
    """counts()["frames"] grows by one a step and by num_frames a step_n,
    on the step loop and on the rehearsed capture, which adds its warm-up
    frames once (the capture itself runs nothing)."""
    from test_torch_frame_loop import _rehearse

    r = _renderer()
    state = r.init_state()
    n0 = spans.counts()["frames"]
    state, _, _ = r.step(state)
    assert spans.counts()["frames"] == n0 + 1
    state, _ = r.step_n(state, 3)
    assert spans.counts()["frames"] == n0 + 4
    _rehearse(monkeypatch, r)
    state, _ = r.step_n(state, 2)
    assert spans.counts()["frames"] == n0 + 6 + t_renderer.CAPTURE_WARMUP
    r.step_n(state, 2)
    assert spans.counts()["frames"] == n0 + 8 + t_renderer.CAPTURE_WARMUP


@pytest.mark.parametrize("column,key", list(enumerate(spans.K1_COUNTS)))
def test_counts_read_each_k1_count_a_wave(column, key):
    """counts() gives each of K1's counts (box tests, triangle tests,
    instance entries) as one number a wave: its column of every device's
    counters, summed over the K1_SLOTS rows; the others stay as they
    were."""
    stats = spans.k1_stats("cpu")
    assert stats.shape == (len(spans.WAVES), spans.K1_SLOTS,
                           len(spans.K1_COUNTS))
    before = spans.counts()
    added = torch.zeros_like(stats)
    added[:, 3, column] = torch.tensor([5, 7, 11])
    added[:, spans.K1_SLOTS - 1, column] = torch.tensor([1, 0, 2])
    stats += added
    try:
        got = spans.counts()
    finally:
        stats -= added
    assert set(got) == {*spans.K1_COUNTS, "frames"}
    assert [g - b for g, b in zip(got[key], before[key])] == [6, 7, 13]
    for other in spans.K1_COUNTS:
        assert len(got[other]) == len(spans.WAVES)
        if other != key:
            assert got[other] == before[other]
    assert got["frames"] == before["frames"]


@pytest.mark.parametrize("shape,layout", [((2,), (1, 2)), ((3,), (1, 3)),
                                          ((128, 2), (128, 2)),
                                          ((7, 3), (7, 3)),
                                          ((4,), None), ((6,), None),
                                          ((5, 4), None), ((0, 3), None),
                                          ((2, 5, 3), None)])
def test_k1_stats_take_two_or_three_counts_a_row(shape, layout):
    """K1's stats: one row or n rows of 2 (box and triangle tests) or 3
    (instance entries besides); any other shape is refused."""
    stats = torch.zeros(shape, dtype=torch.int64)
    if layout is None:
        with pytest.raises(ValueError, match="stats"):
            fused.stat_layout(stats)
    else:
        assert fused.stat_layout(stats) == layout


@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_wide_tracer_gives_each_wave_its_counter_row(monkeypatch, metallic):
    """The "wide" frame hands K1 row i of the device's counters in its
    i-th wave, K1_SLOTS rows of all three counts; K1's plain version on
    the CPU leaves them untouched."""
    seen = []

    def recording(*args, stats=None, **kw):
        seen.append(stats)
        return trace_scene_wide_fused(*args, stats=stats, **kw)

    monkeypatch.setattr(t_renderer, "trace_scene_wide_fused", recording)
    r = _renderer(metallic=metallic)
    rows = spans.k1_stats("cpu")
    before = rows.clone()
    r.step(r.init_state())
    waves = 3 if metallic < 1.0 else 2
    assert [s.data_ptr() for s in seen] == \
        [rows[i].data_ptr() for i in range(waves)]
    assert all(fused.stat_layout(s) == (spans.K1_SLOTS, 3) for s in seen)
    assert torch.equal(rows, before)


def test_stage_ms_pairs_marks_into_frames():
    """A frame runs from a refit mark to the next end mark; a stage lasts
    to the next mark; a stage no frame ran is left out; marks outside a
    frame are not counted."""
    order = ["refit", "primary", "reflection", "spatial", "taa", "tonemap",
             "end"]
    marks = [("tonemap", -5.0), ("end", -1.0)]
    for f in range(2):
        marks += [(s, 1000.0 * f + 100.0 * i) for i, s in enumerate(order)]
    marks.append(("refit", 5000.0))
    got = spans.stage_ms(marks)
    assert list(got) == order[:-1]
    assert all(v == pytest.approx(0.1) for v in got.values())


@pytest.mark.parametrize("metallic", [None, 0.5])
def test_marked_pass_equals_the_parity_golden(metallic):
    """ray_trace_pass with a recording mark gives the unmarked pass's
    outputs bit for bit, marks its waves in order, and holds the parity
    bars against the JAX package (tests/test_torch_raygen.py)."""
    from test_torch_raygen import H as RH, W as RW, _frame, _port_pass, \
        _ref_pass
    from raytracedggx_tpu_torch.ops.ordering import make_block_order
    from raytracedggx_tpu_torch.trace import raygen as tr

    ref, port = _frame(metallic)
    sw, seen = port["sw"], []
    marked = tr.ray_trace_pass(
        port["tlas"], port["consts"], port["mats"], port["env"], port["sh"],
        RW, RH, trace_fused=lambda o, d, a, b: trace_scene_wide_fused(
            sw, o, d, a, b),
        ray_order=make_block_order(RW, RH), mark=seen.append)
    assert seen == ["primary", "reflection"] + (
        ["diffuse"] if metallic is not None else [])
    plain = _port_pass(port)
    assert plain.keys() == marked.keys()
    for k in plain:
        assert torch.equal(plain[k], marked[k]), k
    want = {k: np.asarray(v) for k, v in _ref_pass(ref).items()}
    same = marked["vis"].numpy() == want["vis"].astype(np.int64)
    assert same.mean() >= 0.99
    for k in ("normal", "rough_metal", "depth", "velocity", "refl", "diff"):
        np.testing.assert_allclose(marked[k].numpy()[same], want[k][same],
                                   atol=1e-4, err_msg=k)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc on sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_replay_shows_the_marks_in_order_each_frame(cuda, metallic):
    """A traced step_n replay shows the rtggx_mark_* kernels, one set a
    frame in the stage order, on the device."""
    r = _renderer(cuda, metallic, 96, 54)
    state, _ = r.step_n(r.init_state(), 1)          # captures
    _, got = _marks(lambda: r.step_n(state, 3))
    assert got == _order(metallic) * 3


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("metallic", [1.0, 0.5])
def test_counters_equal_k1_stats_of_the_frame_waves(cuda, metallic, slim):
    """One step adds to each wave's row of the counters exactly the box
    tests, triangle tests and instance entries K1 reports for that wave's
    inputs (taken through trace_hook) in a launch of its own."""
    r = _renderer(cuda, metallic, 96, 54, trace_slim=slim)
    waves = []
    keep = dict(memory_format=torch.contiguous_format)
    r.trace_hook = lambda sw, o, d, a, b: waves.append(
        (sw, o.clone(**keep), d.clone(**keep), a,
         b.clone(**keep) if torch.is_tensor(b) else b))
    state = r.init_state()
    state, _, _ = r.step(state)                     # builds the kernels
    waves.clear()
    before = spans.k1_stats(cuda).clone()
    r.step(state)
    torch.cuda.synchronize()
    added = (spans.k1_stats(cuda) - before).sum(dim=1)
    assert len(waves) == (3 if metallic < 1.0 else 2)
    for i, (sw, o, d, a, b) in enumerate(waves):
        own = torch.zeros(3, dtype=torch.int64, device=cuda)
        fused.trace_tiles_instanced(sw.nodes, sw.tris4, sw.inv_mats,
                                    sw.inst_slots, o, d, a, b, sw.leaf_size,
                                    sw.k1_stack, own, slim=slim)
        assert own[0] > 0 and own[2] > 0, (i, own)
        assert torch.equal(added[i], own), (i, added, own)
    assert not added[len(waves):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 3])
@pytest.mark.parametrize("slots", [1, 7])
@pytest.mark.parametrize("mode", ["lean", "slim", "fat"])
def test_trace_scene_wide_fused_forwards_stats(cuda, mode, slots, width):
    """trace_scene_wide_fused(stats=) adds what K1 counts in each mode,
    spread over the rows of an (n, width) tensor as over one row; the
    box and triangle tests are the same whether the instance entries are
    counted or not."""
    scene = _scene()
    sw = refit_scene_wide(build_scene_wide(
        upload_scene(scene, cuda), scene.mesh_ids, device=cuda,
        lean=mode != "fat"), scene.worlds(0.3).to(cuda))
    rng = np.random.default_rng(3)
    o = torch.as_tensor(rng.uniform(-4, 4, (4096, 3)).astype(np.float32),
                        device=cuda) + torch.tensor([0.0, 6.0, 0.0],
                                                    device=cuda)
    d = torch.nn.functional.normalize(-o + torch.as_tensor(
        rng.uniform(-1, 1, (4096, 3)).astype(np.float32), device=cuda),
        dim=-1)
    t_max = torch.full((4096,), 1e30, device=cuda)
    got = torch.zeros((slots, width), dtype=torch.int64, device=cuda)
    trace_scene_wide_fused(sw, o, d, 0.0, t_max, slim=mode == "slim",
                           stats=got)
    assert (got[:, 0] > 0).all()         # 32 blocks of rays: every row
    got = got.sum(dim=0)
    want = torch.zeros(3, dtype=torch.int64, device=cuda)
    fused.trace_tiles_instanced(
        sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, o, d, 0.0, t_max,
        sw.leaf_size, sw.k1_stack, want, slim=mode == "slim",
        lean=mode != "fat", attrs4=None if mode != "fat" else sw.attrs4)
    assert got[1] > 0 and want[2] > 0 and torch.equal(got, want[:width])


@pytest.mark.cuda
def test_captured_frame_with_marks_equals_step(cuda):
    """With its marks and counters the captured frame still equals the
    step loop bit for bit; each replay counts a frame and adds to the
    counters exactly what the same frames add through step."""
    loop = chunk = _renderer(cuda, 0.5, 96, 54)
    s_loop = s_chunk = loop.init_state()
    s_chunk, _ = chunk.step_n(s_chunk, 1)           # captures
    s_loop, _, _ = loop.step(s_loop)
    n0, k0 = spans.counts()["frames"], spans.k1_stats(cuda).clone()
    for _ in range(3):
        s_loop, f_loop, _ = loop.step(s_loop)
    n1, k1 = spans.counts()["frames"], spans.k1_stats(cuda).clone()
    s_chunk, f_chunk = chunk.step_n(s_chunk, 3)
    torch.cuda.synchronize()
    assert torch.equal(f_loop, f_chunk)
    assert torch.equal(s_loop.history, s_chunk.history)
    assert n1 - n0 == 3 and spans.counts()["frames"] - n1 == 3
    by_step = (k1 - k0).sum(dim=1)
    assert (by_step > 0).all()           # three waves, every count
    assert torch.equal((spans.k1_stats(cuda) - k1).sum(dim=1), by_step)


def _instance_boxes(sw):
    """(lo, hi) of the top tree's kind-3 children, the instance world
    boxes K1 tests, as its node rows hold them."""
    rows = sw.nodes.cpu()
    lo, hi = [], []
    for k in range(4):
        entry = rows[:, 24 + k] == 3
        lo.append(rows[entry, 6 * k:6 * k + 3])
        hi.append(rows[entry, 6 * k + 3:6 * k + 6])
    return torch.cat(lo), torch.cat(hi)


def _slab_entries(lo, hi, o, d, t_min, t_max):
    """Per ray, the boxes its segment [t_min, t_max] crosses: K1's slab
    test (ray.cuh: box_hit, safe_inv) in float32, on the CPU."""
    eps = torch.tensor(1e-20)
    d = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / d
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return ((tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])).sum(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lean", "slim", "fat"])
def test_k1_counts_the_instances_each_ray_enters(cuda, mode):
    """Over 3 extra instances, one live ray a block of 128 so that each
    row of the stats is one ray's: a ray that hits nothing entered
    exactly the instance world boxes its segment crosses (a plain slab
    test); a ray that hit entered at least one.  Counting them changes
    none of K1's outputs nor its other counts."""
    extra = ((0.0, 0.0, -2.5, 0.6), (2.5, 0.0, -2.5, 0.6),
             (-2.5, 0.0, 0.0, 0.6))
    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0.0, 1.0, 0.0, 1.0], np.float32),
                  extra_instances=extra)
    sw = refit_scene_wide(build_scene_wide(
        upload_scene(scene, cuda), scene.mesh_ids, device=cuda,
        lean=mode != "fat"), scene.worlds(0.7).to(cuda))
    lo, hi = _instance_boxes(sw)
    assert len(lo) == len(scene.mesh_ids) == 5
    rng = np.random.default_rng(11)
    n = 2048
    o = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6.0, n)
    aim = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    aim[:, 1] = rng.uniform(-1.0, 3.0, n)
    d = aim - o
    d[n // 2:] *= -1.0                   # half of them away: many misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(2.0, 12.0, n).astype(np.float32)
    # ray i alone in block i: the rest of the block dead (t_max < 0)
    big_o = torch.zeros((n, 128, 3))
    big_d = torch.zeros((n, 128, 3))
    big_d[..., 1] = 1.0
    big_t = torch.full((n, 128), -1.0)
    big_o[:, 0], big_d[:, 0] = torch.as_tensor(o), torch.as_tensor(d)
    big_t[:, 0] = torch.as_tensor(t_max)
    args = (big_o.reshape(-1, 3).to(cuda), big_d.reshape(-1, 3).to(cuda),
            0.0, big_t.reshape(-1).to(cuda))
    kw = dict(slim=mode == "slim", lean=mode != "fat",
              attrs4=sw.attrs4 if mode == "fat" else None)

    def k1(stats):
        return fused.trace_tiles_instanced(
            sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, *args,
            sw.leaf_size, sw.k1_stack, stats, **kw)

    plain_out = k1(None)
    two = torch.zeros((n, 2), dtype=torch.int64, device=cuda)
    three = torch.zeros((n, 3), dtype=torch.int64, device=cuda)
    two_out, three_out = k1(two), k1(three)
    torch.cuda.synchronize()
    for a, b, c in zip(plain_out, two_out, three_out):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(three[:, :2], two)
    entries = three[:, 2].cpu()
    hit = (plain_out[-1].reshape(n, 128)[:, 0] >= 0).cpu()
    want = _slab_entries(lo, hi, torch.as_tensor(o), torch.as_tensor(d),
                         0.0, torch.as_tensor(t_max))
    assert 0.1 < float(hit.float().mean()) < 0.9
    assert (want[~hit] > 0).any()        # misses that entered instances
    assert torch.equal(entries[~hit], want[~hit])
    assert (entries[hit] >= 1).all()
    assert (entries[hit] <= want[hit]).all()
