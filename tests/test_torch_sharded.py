"""PyTorch port parity, the row-band renderer (parallel/sharded.py) and
its hooks: ``halo_exchange_rows`` against the reference's under
``shard_map`` over 4 of the 8 virtual CPU devices, exactly; a band of
``ray_trace_pass(row0=, band_height=)`` against the full pass's rows,
exactly, and against the reference's band at the ray-trace parity bars;
``temporal_ss(full_size=)`` on a band against the reference's; and
``ShardedRenderer(("cpu",) * 4)`` against the port's single-device
``Renderer`` within one f16 ulp (the bar of tests/test_sharded.py:47).
The bands run in this process, one after another: no process group."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raytracedggx_tpu.denoise.temporal import temporal_ss as j_temporal
from raytracedggx_tpu.ops.traverse_pallas import make_block_order as j_order
from raytracedggx_tpu.parallel.sharded import AXIS as J_AXIS
from raytracedggx_tpu.parallel.sharded import \
    halo_exchange_rows as j_halo_exchange
from raytracedggx_tpu.parallel.sharded import make_row_mesh as j_row_mesh
from raytracedggx_tpu.trace import raygen as jr

from raytracedggx_tpu_torch.denoise import temporal_ss
from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.ops.ordering import make_block_order
from raytracedggx_tpu_torch.ops.scene_wide import trace_scene_wide_fused
from raytracedggx_tpu_torch.parallel import (ShardedRenderer,
                                             halo_exchange_rows,
                                             make_row_mesh)
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.trace import raygen as tr

from test_torch_raygen import H as RH, W as RW, _frame, jax_bruteforce_fused

W, H = 64, 64          # 4 bands of 16 rows
CPU4 = ("cpu",) * 4
F16_ULP = 5e-4         # one f16 ulp at radiance ~1 (tests/test_sharded.py:47)
# (row0, band_height) of bands of the 32x18 pass: the first with rows
# above the image, the last with rows below it; no aligned block tiling
# divides these heights, so the ray order is an index permutation
BANDS = [(-4, 10), (5, 9), (12, 10)]


def tiny_scene():
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(),
                 pos_scale=np.array([0, 3.0, 0, 1.0], np.float32))


@pytest.mark.parametrize("edge", ["zero", "clamp"])
def test_halo_exchange_matches_reference(edge):
    n, halo = 4, 3
    rows = 6 * n
    x = (np.arange(rows * 5 * 2, dtype=np.float32).reshape(rows, 5, 2)
         + 1.0)
    mesh = j_row_mesh(jax.devices()[:n])
    fn = jax.jit(jax.shard_map(
        partial(j_halo_exchange, halo=halo, edge=edge), mesh=mesh,
        in_specs=P(J_AXIS), out_specs=P(J_AXIS), check_vma=False))
    want = np.asarray(fn(jnp.asarray(x))).reshape(n, 6 + 2 * halo, 5, 2)
    bands = list(torch.as_tensor(x).reshape(n, 6, 5, 2).unbind(0))
    got = halo_exchange_rows(bands, halo, edge=edge)
    assert len(got) == n
    for b in range(n):
        np.testing.assert_array_equal(got[b].numpy(), want[b])


def test_halo_exchange_rejects_unknown_edge():
    with pytest.raises(ValueError, match="edge"):
        halo_exchange_rows([torch.zeros(4, 2)] * 2, 1, edge="wrap")


def _port_pass(port, row0=0, band_height=None):
    sw = port["sw"]
    bh = RH if band_height is None else band_height
    return tr.ray_trace_pass(
        port["tlas"], port["consts"], port["mats"], port["env"], port["sh"],
        RW, RH, trace_fused=lambda o, d, a, b: trace_scene_wide_fused(
            sw, o, d, a, b),
        ray_order=make_block_order(RW, bh), row0=row0, band_height=bh)


@pytest.mark.parametrize("metallic", [None, 0.5])
def test_band_pass_equals_full_rows(metallic):
    """Each band's rows inside the image equal the full pass's, bit for
    bit, on the port's plain traversal (the RNG keyed on global pixel
    ids, rays traced one by one)."""
    _, port = _frame(metallic)
    full = _port_pass(port)
    for row0, bh in BANDS:
        band = _port_pass(port, row0, bh)
        lo, hi = max(row0, 0), min(row0 + bh, RH)
        for k, v in full.items():
            assert band[k].shape[:2] == (bh, RW), k
            assert torch.equal(band[k][lo - row0:hi - row0], v[lo:hi]), \
                f"{k} rows {lo}:{hi}"


@pytest.mark.parametrize("metallic", [None, 0.5])
def test_band_pass_matches_reference(metallic):
    """The port's band against the reference's
    ``ray_trace_pass(row0=, band_height=)`` at the bars of
    tests/test_torch_raygen.py, rows outside the image included."""
    ref, port = _frame(metallic)
    sw = ref["sw"]
    for row0, bh in BANDS:
        order, inv = j_order(RW, bh)
        want = jr.ray_trace_pass(
            None, ref["tlas"], ref["consts"], ref["mats"], ref["env"],
            ref["sh"], RW, RH, row0=row0, band_height=bh,
            trace_fused=lambda o, d, a, b: jax_bruteforce_fused(
                sw, o, d, a, b),
            ray_order=(jnp.asarray(order), jnp.asarray(inv)),
            sort_secondary=True)
        want = {k: np.asarray(v) for k, v in want.items()}
        got = {k: v.numpy() for k, v in _port_pass(port, row0, bh).items()}
        same = got["vis"] == want["vis"].astype(np.int64)
        assert same.mean() >= 0.99, f"vis agrees on {same.mean():.4f}"
        for k in ("normal", "rough_metal", "depth", "velocity", "refl",
                  "diff"):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k][same], want[k][same],
                                       atol=1e-4, err_msg=f"{k} {row0}")


@pytest.mark.parametrize("motion", [0.004, 0.2])   # tent / gather branch
def test_temporal_full_size_matches_reference(motion):
    """A (24, 40) band of a 40x96 image: the reprojection and the blur
    estimate scale by the full viewport."""
    rng = np.random.default_rng(11)
    h, w, full = 24, 40, (40, 96)
    cur = rng.random((h, w, 4)).astype(np.float32) * 2
    cur[..., 3] = (rng.random((h, w)) > 0.3).astype(np.float32)
    hist = (rng.random((h, w, 4)) * 2).astype(np.float16)
    vel = ((rng.random((h, w, 2)) - 0.5) * motion).astype(np.float32)
    want = np.asarray(j_temporal(jnp.asarray(cur), jnp.asarray(hist),
                                 jnp.asarray(vel), full_size=full))
    got = temporal_ss(torch.as_tensor(cur), torch.as_tensor(hist),
                      torch.as_tensor(vel), full_size=full).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    local = temporal_ss(torch.as_tensor(cur), torch.as_tensor(hist),
                        torch.as_tensor(vel)).numpy()
    assert np.abs(local - want).max() > 1e-3   # full_size is not a no-op


@pytest.mark.parametrize("motion, margin", [(0.004, 3), (0.05, 6)])
def test_temporal_band_rows_equal_the_image_rows(motion, margin):
    """``temporal_ss(full_size=, row0=)`` on rows [20, 60) of a 96-row
    image: every row whose neighbourhood and reprojection stay inside the
    band equals the whole image's bit for bit (the reprojection and its
    bilinear weights are taken in the image's row coordinates)."""
    rng = np.random.default_rng(5)
    h, w, r0, hb = 96, 40, 20, 40
    cur = torch.as_tensor(rng.random((h, w, 4)).astype(np.float32) * 2)
    cur[..., 3] = torch.as_tensor((rng.random((h, w)) > 0.3).astype(
        np.float32))
    hist = torch.as_tensor((rng.random((h, w, 4)) * 2).astype(np.float16))
    vel = torch.as_tensor(((rng.random((h, w, 2)) - 0.5) * motion).astype(
        np.float32))
    want = temporal_ss(cur, hist, vel)
    rows = slice(r0, r0 + hb)
    got = temporal_ss(cur[rows], hist[rows], vel[rows], full_size=(w, h),
                      row0=r0)
    assert torch.equal(got[margin:hb - margin],
                       want[r0 + margin:r0 + hb - margin])


def _drive(r, frames, dt):
    s = r.init_state()
    f = None
    for _ in range(frames):
        s, f, _ = r.step(s, dt)
    return s, f


@pytest.mark.parametrize("metallic, height, halo", [(1.0, H, 8),
                                                    (1.0, 2 * H, 24),
                                                    (0.5, 2 * H, 24)])
def test_sharded_matches_single_device(metallic, height, halo):
    """4 bands with a halo against the single-device frame over 3 frames
    (tests/test_sharded.py:21-50): 16 rows with halo 8 at metallic 1,
    within one f16 ulp; 32 rows with halo 24, bit for bit, as the halo
    covers the filters' 16-row reach plus the TAA neighbourhood.  At
    metallic 0.5 the diffuse wave and filter run on each band."""
    cfg = RenderConfig(width=W, height=height)
    single = Renderer(tiny_scene(), config=cfg, device="cpu")
    sharded = ShardedRenderer(tiny_scene(), mesh=make_row_mesh(CPU4),
                              halo=halo, config=cfg)
    for r in (single, sharded):
        for mesh_idx in (0, 1):
            r.set_metallic(mesh_idx, metallic)
    s1, f1 = _drive(single, 3, 1 / 60)
    s2, f2 = _drive(sharded, 3, 1 / 60)
    assert f1.shape == f2.shape == (height, W, 3)
    diff = (f1 - f2).abs().max().item()
    assert diff < F16_ULP, f"max diff {diff}"
    if halo > 17:
        assert diff == 0.0
    assert s2.frame == 3
    assert len(s2.history) == 4
    assert all(b.shape == (height // 4, W, 4) and b.dtype == torch.float16
               for b in s2.history)
    torch.testing.assert_close(s2.prev_wvp, s1.prev_wvp, rtol=0, atol=0)
    # the stored history: adjacent f16 values at most (one ulp relative)
    np.testing.assert_allclose(torch.cat(s2.history).float().numpy(),
                               s1.history.float().numpy(), atol=F16_ULP,
                               rtol=2.0 ** -10)


def test_sharded_fast_motion_halo():
    """dt = 0.25 (4 degrees a frame, tests/test_sharded.py:67-100): the
    TAA reprojection and the velocity dilation cross band borders.  Halo 8
    holds to one f16 ulp (:47, not :92's 1e-4, which the reference's own
    f16 history misses); a starved halo of 1 must differ."""
    cfg = RenderConfig(width=W, height=H)
    _, ref = _drive(Renderer(tiny_scene(), config=cfg, device="cpu"), 4, 0.25)
    _, good = _drive(ShardedRenderer(tiny_scene(), mesh=CPU4, halo=8,
                                     config=cfg), 4, 0.25)
    good_diff = (ref - good).abs().max().item()
    assert good_diff < F16_ULP, f"halo=8 fast-motion mismatch {good_diff}"
    _, starved = _drive(ShardedRenderer(tiny_scene(), mesh=CPU4, halo=1,
                                        config=cfg), 4, 0.25)
    assert (ref - starved).abs().max().item() > 1e-3, \
        "halo=1 matched the single-device frame under fast motion"


def test_sharded_step_n_is_the_band_loop():
    cfg = RenderConfig(width=W, height=H)
    r = ShardedRenderer(tiny_scene(), mesh=CPU4, halo=4, config=cfg)
    assert not r.captures
    s_loop, f_loop = _drive(r, 2, 1 / 60)
    s_n, f_n = r.step_n(r.init_state(), 2)
    assert torch.equal(f_loop, f_n)
    assert all(torch.equal(a, b) for a, b in zip(s_loop.history,
                                                 s_n.history))


def test_sharded_layout():
    """Geometry and constants once per distinct device; the halo capped
    at the band; the height must divide into the bands."""
    cfg = RenderConfig(width=32, height=16)
    r = ShardedRenderer(tiny_scene(), mesh=CPU4, halo=32, config=cfg)
    assert r.mesh == (torch.device("cpu"),) * 4
    assert list(r._by_device) == [torch.device("cpu")]
    assert (r.band, r.halo) == (4, 4)
    with pytest.raises(AssertionError, match="divide"):
        ShardedRenderer(tiny_scene(), mesh=("cpu",) * 3, config=cfg)
