#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's frame paths once on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure ends the run non-zero):
 0. the machine: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
 1. build the CUDA kernels from csrc/ (one nvcc per source, sm_90a) and
    load them; print ptxas's registers, stack frame and spills of every
    kernel, and fail if one of K1's 3 instances (lean, slim K1s, fat K1f),
    K1e, K4, K5, K7 or an instance of K6a, K6b, XF, TS or BS has a stack
    frame or spills;
 2. the scene: ground cube + a deterministic ~82k-triangle displaced
    icosphere standing in for the bunny; its instanced scene BVH (the
    renderer's leaf size, 8) for traversal="wide" and its per-mesh trees
    (leaf 8) for "pallas" (FlatBVH) and "pallas4" (WideBVH);
 3. each kernel against its plain torch version on the card, at the shapes
    the frame gives it: K1 at the renderer's leaf size and at 64 on the
    frame's two full waves (921,600 primary rays in screen-block order,
    921,600 sorted reflection rays, as the renderer hands them to K1), on
    16,384 rays drawn from them, and on the 9-instance nested scene; K1s
    and K1f at the renderer's leaf size on the check rays and both full
    waves, against their plain versions and against lean K1 on the card
    (hits, slot / prim and inst exact, t at rtol 1e-6; u, v and the
    normal after the slim recompute at atol 1e-4, the fat normal at atol
    1e-5, its u, v equal to lean's), and K1e, the slim recompute, on K1s's
    slot and inst against lean K1's u, v and against its plain version
    within 4 eps times each ray's float32 condition (``uv_condition``); K4
    and K5 in the model instance's object space on 16,384 rays of the frame
    and on the frame's two full waves (one plain run per wave, compared by
    triangle id), and through their per-instance loop on the nested
    scene; K2/K3 on 1280x720 G-buffers, both axes; XF, the waves'
    per-instance transforms, in its three forms on 921,600 rays against
    its plain version (take_small + einsum) and the einsum alone; TS, the
    TAA, bit for bit its plain version at 1280x720, 3840x2160, 67x37 and
    on a band, timed beside it at the two frame sizes; BS, the bounce
    waves' shading, bit for bit its plain version on the frame's sorted
    waves at 1280x720 and over 8 instances at 3840x2160, metallic 1 and
    0.5, timed beside it on each size's reflection wave;
 4. the paths at 1280x720, each with every launch count set to 0 just
    before it and read just after: "wide" (3 warm-up, 60 timed frames, then
    10 at metallic 0.5), then "pallas4" and "pallas" (3 warm-up, 20 timed,
    then 5 at metallic 0.5); then "wide" at kernels="xla" (K1 launched,
    the filters' plain passes), and after set_kernels("auto") K2 again;
    then the knobs: "wide" with trace_slim (K1s in every wave, no lean K1)
    and with sort_dir_bits=6, paired with the default "wide" frame in one
    run (3 warm-up, 20 timed frames each in two halves in the order
    default, slim, dir6, dir6, slim, default, then 5 at metallic 0.5),
    each frame held against the default frame of the same step at the
    golden bar (max 0.02, mean 0.002); last, K1f's API path,
    build_scene_wide(lean=False) and trace_scene_wide_fused over the
    frame's two waves;
 5. the golden cube scene at 96x54, 3 frames, against the JAX package's
    frozen PNGs: the default frame and bary_mode="ndc" with
    emulate_formats, each on "pallas4" and "pallas" (the default frame
    also on "wide");
 6. the kernel lab: the kbench port's ray sets at 1280x720 over the model
    scene's trees (leaf 8, 16, 32, 64); for each of 18 variants covering
    every flag, K6a / K6b / K7 against its plain version on 16,384 rays
    (hits, per-ray visit counts, the deepest stack against the walk's
    bound, times, bound), then, with the lab's launch counts set to 0 just
    before and read just after, kbench's own run of those variants on both
    full sets with its gate against K1; then K7 and K1 on kbench's
    reflection set from t_min 0, where every ray on which they differ
    beyond the gate must have its nearer t below kbench's t_min (a re-hit
    of the ray's own start triangle); last, the bound of each JSON row's
    lab variant on kbench's two full sets;
 7. the frame loop and the CLI at 1280x720 on the model scene: on
    "wide", "wide" with trace_slim, "pallas4" and "pallas", step_n (one
    frame captured into a CUDA graph and replayed) against a step loop of
    the same renderer from the same state, bit for bit, at metallic 1 and
    across a set_metallic to 0.5 (a new capture); each captured frame's
    launches (counted at capture), the counters over warm-up and capture,
    and one replayed chunk's kernels by name under torch.profiler;
    async_compute on against off, bit for bit, and the refit's operations
    on a second stream in the profiler; ms/frame of the eager step loop
    and of captured chunks in halves (eager, captured, captured, eager)
    at metallic 1 and 0.5, with each one's device busy ms/frame and idle
    share; last, the CLI as a subprocess on the model written to an OBJ
    (its PNG equal to Renderer's frame after the same 8 steps), with
    --stage-times, and --interactive with a command script;
 8. the port's bench as a user runs it: ``python -m
    raytracedggx_tpu_torch.bench`` as a subprocess for config 0 and config
    6 (metallic 0.5, the three-wave frame) at RTGGX_BENCH_FRAMES=30: one
    JSON line each, the right metric, value > 0, the live-ray count of its
    note equal to the count of a step's G-buffers in this process, and its
    launches (counted in the child from 0, over its warm-up step and
    step_n's warm-up and capture) those of its path; a sentinel fails;
 9. the row bands: ShardedRenderer with 4 bands of 180 rows on the card
    (halo 32) against Renderer at 1280x720 over 3 frames, at metallic 1
    and after set_metallic to 0.5: the frame within one f16 ulp (5e-4),
    the history 4 bands of (180, 1280, 4) f16, K1 and K2 (and K3 at 0.5)
    launched 4x the single-device counts with the counts set to 0 just
    before and read just after; a starved halo of 1 under fast motion (dt
    0.5) must differ from the single-device frame; then ms/frame of the
    step loop at halo 32 and 16 and of the single-device frame, in halves
    (32, 16, single, single, 16, 32).
The second-to-last line is a JSON summary of the kernels (launches on
their path, parity error, kernel / plain times, the bound; K1's, K1s',
K1f's, K4's and K5's times are of the full primary wave, K2's and K3's of
the row pass);
the last line is {"ok": true, "device": {...}}.  Needs CUDA: without it
this exits non-zero and prints no result.  Imports nothing of JAX or the
JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "cube_scene_96x54_f3.png")
GOLDEN_NDC_FMT = os.path.join(ROOT, "tests", "golden",
                              "cube_scene_96x54_ndc_fmt_f3.png")
W, H = 1280, 720
TIMED_FRAMES = 60
METAL_FRAMES = 10
PER_MESH_TIMED, PER_MESH_METAL = 20, 5
KNOB_TIMED, KNOB_METAL = 20, 5      # the knob paths' frames, per path
FAT_REPS = 10                       # K1f's API path: passes over both waves
# the launch counters, in the order of every per-frame list below
COUNTED = ("K1", "K1s", "K1f", "K1e", "K2", "K3", "K4", "K5", "XF",
           "TS", "BS")
F32_EPS = 2.0 ** -23
K1_RAYS = 16384
K1_LEAVES = (8, 64)     # the renderer's leaf size (checked), and the old one
T_MIN_SECONDARY = 1e-5
# the bound: H100 SXM data sheet (dense fp32 outside the tensor cores,
# HBM3), and fp32 operations per test as the kernels' sources count them
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BOX_OPS = 25        # slab test: 6 sub, 6 mul, 6 min/max, 4 min/max, 3 cmp
TRI_OPS = 51        # Moller-Trumbore: 2 cross, 3 dots, rcp, 3 sub, 6 cmp
SLOT_OPS_MXU = 91   # linear form: 4 outputs x 10 FMAs, rcp, 3 mul, 7 cmp/add
# phase 6: the kernel-lab variants checked and driven, the row each kernel
# reports in the JSON line, kbench frames per variant and ray set
LAB_VARIANTS = ("base", "stats", "unordered", "npop1", "npop4", "lean_l16",
                "defer_l64", "fold_l16", "pre_l64", "sub4_l64", "smem",
                "tile16", "ls", "ls_lean", "ls_lean_l16", "ls_lean_smem16",
                "mxu32", "mxu16")
LAB_ROWS = {"K6a": "base", "K6b": "ls_lean_l16", "K7": "mxu32"}
LAB_FRAMES = 10
# phase 7: frames per timed half of the eager / captured pairing, and the
# CLI's frames and interactive script
LOOP_FRAMES = 10
CLI_FRAMES = 8
CLI_SCRIPT = "drag 40 0\nup\na\nv\nrun 2\nquit\n"
# phase 8: the bench's configs and frames; phase 9: the bands, their halo,
# frames per check and per timing, and the fast-motion step
BENCH_CONFIGS = (0, 6)
BENCH_FRAMES = 30
BANDS, BAND_HALO = 4, 32
BAND_FRAMES, BAND_TIMED = 3, 20
FAST_DT, FAST_FRAMES = 0.5, 4


def check(ok, msg):
    if not ok:
        raise SystemExit(f"FAILED: {msg}")
    print(f"  ok: {msg}")


def cuda_ms(fn, reps):
    """Median milliseconds of fn() between CUDA events (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------- phase 0
def machine():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True, timeout=60)
    print((nvcc.stdout or nvcc.stderr).strip().splitlines()[-1])
    return card


# ---------------------------------------------------------------- phase 1
def build_kernels():
    from raytracedggx_tpu_torch.ops import cuda_lib

    path, log, secs = cuda_lib.build()
    cuda_lib.load_library()
    print(f"built {os.path.relpath(path, ROOT)} in {secs:.3f} s")
    reports = cuda_lib.ptxas_reports(log)
    for name, (regs, frame, st, ld) in reports.items():
        print(f"  ptxas {name}: {regs} registers, {frame} bytes stack "
              f"frame, {st} / {ld} bytes spill stores / loads")
    for k, key, n in (("K1", "trace_instanced_kernel", 3),
                      ("K1e", "slim_uv_kernel", 1),
                      ("K4", "trace_flat_pairs_kernel", 1),
                      ("K5", "trace_wide4_kernel", 1),
                      ("K6a", "lab_kernel", 6), ("K6b", "ls_kernel", 2),
                      ("K7", "mxu_kernel", 1),
                      ("XF", "instance_xform_kernel", 3),
                      ("TS", "temporal_ss_kernel", 2),
                      ("BS", "bounce_shade_kernel", 1)):
        rows = [r for name, r in reports.items() if key in name]
        check(len(rows) == n and all(r[1:] == (0, 0, 0) for r in rows),
              f"{k}: {n} instance(s), no stack frame and no spills")
    return secs


# ---------------------------------------------------------------- phase 2
def scene_bvh(scene, angle, device, leaf_size):
    from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                       refit_scene_wide)
    from raytracedggx_tpu_torch.trace.geometry import upload_scene

    geom = upload_scene(scene, device)
    sw = build_scene_wide(geom, scene.mesh_ids, leaf_size=leaf_size,
                          device=device)
    return refit_scene_wide(sw, scene.worlds(angle).to(device))


# ---------------------------------------------------------------- phase 3
def rand_rays(rng, n, device):
    """The ray pattern of tests/test_scene_wide.py:_rand_rays."""
    o = rng.uniform(-6.0, 6.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 8.0, size=n)
    d = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of bytes over the HBM rate and fp32 operations over the
    fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_bound(inputs, n_rays, out_bytes_per_ray, stats, tri_ops=TRI_OPS):
    """Bound of a closest-hit launch: each input read once and each output
    written once; the box and triangle tests counted by the kernel on
    these rays, ``tri_ops`` operations per triangle test."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs if t is not None)
    n_box, n_tri = (int(x) for x in stats.tolist())
    print(f"    {n_box} box tests, {n_tri} triangle tests "
          f"({n_box / n_rays:.2f} / {n_tri / n_rays:.2f} per ray)")
    return bound(nbytes + n_rays * out_bytes_per_ray,
                 BOX_OPS * n_box + tri_ops * n_tri)


def hold_hits(name, got, ref, t_max):
    """The traversal bar of tests/test_scene_wide.py:56-63 on (t, id,
    inst) triples (inst None for one mesh): exact hit mask, t at rtol 1e-4
    atol 1e-5, (id, inst) equal on >= 99% of hits, dead rays miss.
    Returns the max |dt| over hits."""
    (g_t, g_id, g_inst), (r_t, r_id, r_inst) = got, ref
    g_hit, r_hit = g_id >= 0, r_id >= 0
    n_diff = int((g_hit != r_hit).sum())
    check(n_diff == 0, f"{name}: hit mask exact ({int(r_hit.sum())} hits "
          f"of {g_t.shape[0]} rays, {n_diff} differ)")
    err = (g_t[r_hit] - r_t[r_hit]).abs()
    tol = 1e-5 + 1e-4 * r_t[r_hit].abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(bool((err <= tol).all()), f"{name}: t at rtol 1e-4 atol 1e-5 "
          f"(max |dt| {max_err:.3e})")
    same = g_id == r_id
    if g_inst is not None:
        same = same & (g_inst == r_inst)
    frac = float(same[r_hit].float().mean())
    check(frac >= 0.99, f"{name}: ids agree on {frac:.5f} of hits")
    dead = t_max < 0
    check(not bool((g_hit & dead).any()), f"{name}: all "
          f"{int(dead.sum())} rays with t_max < 0 miss")
    return max_err


def time_pair(name, kern, plain, kern_reps=20, plain_reps=3):
    ms, plain_ms = cuda_ms(kern, kern_reps), cuda_ms(plain, plain_reps)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return ms, plain_ms


def k1_check(name, sw, o, d, t_max, t_min=0.0, reps=20):
    """K1 against its plain version on the same rays; returns a dict of
    max |dt| over hits, kernel and plain ms, and the bound.  The plain
    version runs once (it is timed on that run)."""
    from raytracedggx_tpu_torch.ops.fused import (trace_instanced_plain,
                                                  trace_tiles_instanced)

    name = f"K1 L{sw.leaf_size} {name}"

    def kern(stats=None):
        return trace_tiles_instanced(sw.nodes, sw.tris4, sw.inv_mats,
                                     sw.inst_slots, o, d, t_min, t_max,
                                     sw.leaf_size, sw.k1_stack, stats)

    ref, plain_ms = timed_once(lambda: trace_instanced_plain(
        sw.tris, sw.inv_mats, sw.inst_slots, o, d, t_min, t_max))
    got = kern()
    torch.cuda.synchronize()
    err = hold_hits(name, (got[0], got[3], got[4]), (ref[0], ref[3], ref[4]),
                    t_max)
    del ref
    stats = torch.zeros(2, dtype=torch.int64, device=o.device)
    kern(stats)
    # the bytes the function needs: the (S, 9) slots (tris4 only pads them)
    bound_ms, bound_by = trace_bound(
        (sw.nodes, sw.tris, sw.inv_mats, o, d, t_max), o.shape[0], 20, stats)
    ms = cuda_ms(kern, reps)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k1_modes_check(name, sw, o, d, t_max, t_min=0.0, reps=20):
    """K1s and K1f on rays (o, d, t_max) from t_min: each against its plain
    version (the traversal bar; once, timed on that run) and against lean
    K1 on the card: hit mask, slot (K1f: prim) and inst exact, t at rtol
    1e-6; K1s' u, v and normal after trace_scene_wide_fused's recompute at
    atol 1e-4 of lean's; K1f's u, v equal to lean's (the same walk and
    leaf test) and its normal at atol 1e-5 of lean's.  Returns
    {"K1s" | "K1f" | "K1e": dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by)} (K1e: ``k1e_check`` on K1s' slot and inst); the bound
    counts 12 (K1s) or 32 (K1f, which also reads attrs) output bytes per
    ray."""
    from raytracedggx_tpu_torch.ops.fused import (attrs4_rows,
                                                  trace_instanced_plain,
                                                  trace_tiles_instanced)
    from raytracedggx_tpu_torch.ops.scene_wide import trace_scene_wide_fused

    args = (sw.nodes, sw.tris4, sw.inv_mats, sw.inst_slots, o, d, t_min,
            t_max, sw.leaf_size, sw.k1_stack)
    lean = trace_tiles_instanced(*args)
    rec_l, n_l = trace_scene_wide_fused(sw, o, d, t_min, t_max)
    hit = lean[3] >= 0
    modes = {"K1s": (dict(slim=True), dict(slim=True), 12, ()),
             "K1f": (dict(lean=False, attrs4=attrs4_rows(sw.attrs)),
                     dict(lean=False, attrs=sw.attrs), 32, (sw.attrs,))}
    rows = {}
    for key, (kw, plain_kw, out_bytes, extra) in modes.items():
        label = f"{key} L{sw.leaf_size} {name}"

        def kern(stats=None):
            return trace_tiles_instanced(*args, stats, **kw)

        ref, plain_ms = timed_once(lambda: trace_instanced_plain(
            sw.tris, sw.inv_mats, sw.inst_slots, o, d, t_min, t_max,
            **plain_kw))
        got = kern()
        torch.cuda.synchronize()
        g_t, g_id, g_inst = got[0], got[-2], got[-1]
        err = hold_hits(label, (g_t, g_id, g_inst),
                        (ref[0], ref[-2], ref[-1]), t_max)
        del ref
        id_name, want_id = (("slot", lean[3]) if key == "K1s" else
                            ("prim", rec_l.prim.to(torch.int32)))
        same = ((g_id >= 0) == hit).all() and (g_id == want_id).all() \
            and (g_inst == lean[4]).all()
        dt = (g_t - lean[0]).abs()
        check(bool(same) and bool((dt <= 1e-6 * lean[0].abs()).all()),
              f"{label}: against lean K1, hit mask, {id_name} and inst "
              f"exact, t at rtol 1e-6 ({int(hit.sum())} hits, max |dt| "
              f"{float(dt.max()):.3e})")
        if key == "K1s":
            rec_s, n_s = trace_scene_wide_fused(sw, o, d, t_min, t_max,
                                                slim=True)
            diffs = [float((a - b)[hit].abs().max()) if hit.any() else 0.0
                     for a, b in ((rec_s.u, rec_l.u), (rec_s.v, rec_l.v),
                                  (n_s, n_l))]
            check(max(diffs) <= 1e-4, f"{label}: u, v and normal after the "
                  f"recompute at atol 1e-4 of lean K1's (max "
                  f"{diffs[0]:.3e}, {diffs[1]:.3e}, {diffs[2]:.3e})")
            rows["K1e"] = k1e_check(name, sw, o, d, got[1], got[2], lean,
                                    reps)
        else:
            # the same walk and tri_hit as lean: u, v equal bit for bit
            same_uv = torch.equal(got[1], lean[1]) and torch.equal(got[2],
                                                                   lean[2])
            dn = float((got[3] - n_l)[hit].abs().max()) if hit.any() else 0.0
            check(same_uv and dn <= 1e-5, f"{label}: u, v equal to lean "
                  f"K1's on all {o.shape[0]} rays ({same_uv}), normal at "
                  f"atol 1e-5 of lean's (max {dn:.3e})")
        stats = torch.zeros(2, dtype=torch.int64, device=o.device)
        kern(stats)
        bound_ms, bound_by = trace_bound(
            (sw.nodes, sw.tris, sw.inv_mats, o, d, t_max, *extra),
            o.shape[0], out_bytes, stats)
        ms = cuda_ms(kern, reps)
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})")
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return rows


def uv_condition(sw, o, d, slot, inst):
    """Per ray, the scale of a float32 Moller-Trumbore's rounding error in
    u and in v, in float64 from the rows K1e reads: each rounding is at
    most eps times the magnitude of what it rounds, carried to u = (tv .
    pv) / det and v = (d . qv) / det through the object-space ray o*M + T,
    tv = o - v0, pv = d x e2, qv = tv x e1 and det = e1 . pv (first order).
    It grows as |tv| / (|e1| cos) on grazing hits.  0 where slot < 0."""
    hit = slot >= 0
    geo = sw.tris[slot.clamp(min=0).long()].double()
    m = sw.inv_mats[(inst.long() + 1).clamp(0, sw.inv_mats.shape[0] - 1)]
    M, T = m[:, :9].double().reshape(-1, 3, 3), m[:, 9:].double()
    o64, d64 = o.double(), d.double()
    o_obj = torch.einsum("rj,rja->ra", o64, M) + T
    d_obj = torch.einsum("rj,rja->ra", d64, M)
    v0, e1, e2 = geo[:, 0:3], geo[:, 3:6], geo[:, 6:9]

    def n(x):
        return torch.linalg.norm(x, dim=-1)

    a_o = n(torch.einsum("rj,rja->ra", o64.abs(), M.abs()) + T.abs())
    a_d = n(torch.einsum("rj,rja->ra", d64.abs(), M.abs()))
    pv = torch.linalg.cross(d_obj, e2)
    tv = o_obj - v0
    qv = torch.linalg.cross(tv, e1)
    det = (e1 * pv).sum(-1).abs()
    u = (tv * pv).sum(-1) / det
    v = (d_obj * qv).sum(-1) / det
    a_tv = a_o + n(v0) + n(tv)                 # o*M + T, then - v0
    a_pv = a_d * n(e2)                         # d*M, then x e2
    a_det = n(e1) * a_pv
    ku = (a_tv * n(pv) + n(tv) * a_pv + u.abs() * a_det) / det
    kv = (a_d * n(tv) * n(e1) + n(d_obj) * a_tv * n(e1)
          + v.abs() * a_det) / det
    zero = torch.zeros_like(ku)
    return (torch.where(hit, ku, zero).float(),
            torch.where(hit, kv, zero).float())


def k1e_check(name, sw, o, d, slot, inst, lean, reps=20):
    """K1e (K1s's epilogue) on K1s's slot and inst: against lean K1's u, v
    (the walk's arithmetic: expected bit for bit, held at atol 1e-4), and
    against its plain version, an independent float32 recompute, within 4
    eps times each ray's ``uv_condition``.  Returns the JSON row's dict;
    the bound reads each ray's origin, direction, slot and inst, the
    inverse worlds once and each hit's slot row (at most the (S, 9) table
    once), and writes u, v; 33 + 51 operations per hit (the object-space
    ray and Moller-Trumbore).  The plain version is timed over 3 runs."""
    from raytracedggx_tpu_torch.ops.fused import slim_uv, slim_uv_plain

    label = f"K1e L{sw.leaf_size} {name}"

    def kern():
        return slim_uv(sw.tris4, sw.inv_mats, o, d, slot, inst)

    def plain():
        return slim_uv_plain(sw.tris, sw.inv_mats, o, d, slot, inst)

    p_u, p_v = plain()
    plain_ms = cuda_ms(plain, 3)
    u, v = kern()
    torch.cuda.synchronize()
    hit = slot >= 0
    exact = torch.equal(u, lean[1]) and torch.equal(v, lean[2])
    d_l = max(float((u - lean[1]).abs().max()), float((v - lean[2]).abs()
                                                        .max()))
    check(d_l <= 1e-4, f"{label}: u, v at atol 1e-4 of lean K1's on "
          f"{int(hit.sum())} hits (max {d_l:.3e}; bit for bit: {exact})")
    ku, kv = uv_condition(sw, o, d, slot, inst)
    eu, ev = (u - p_u).abs(), (v - p_v).abs()
    ok = (eu <= 1e-6 + 4 * F32_EPS * ku) & (ev <= 1e-6 + 4 * F32_EPS * kv)
    tight = float(((eu <= 1e-4) & (ev <= 1e-4))[hit].float().mean()) \
        if hit.any() else 1.0
    err = max(float(eu.max()), float(ev.max()))
    check(bool(ok.all()), f"{label}: against its plain version within 4 "
          f"eps x the float32 condition (max |du| {float(eu.max()):.3e}, "
          f"|dv| {float(ev.max()):.3e}; within 1e-4 on {tight:.5f} of hits; "
          f"largest condition {float(torch.maximum(ku, kv).max()):.4g})")
    n_hit, R = int(hit.sum()), o.shape[0]
    tables = (min(sw.tris.numel() * 4, n_hit * 36)
              + sw.inv_mats.numel() * 4)
    bound_ms, bound_by = bound(R * (24 + 8 + 8) + tables,
                               (33 + TRI_OPS) * n_hit)
    ms = cuda_ms(kern, reps)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def per_mesh_check(name, tree, kernel, o, d, t_min, t_max, inv):
    """K4 or K5 (``kernel``: its wrapper) against the plain version on one
    mesh's tree, rays moved to object space by the inverse world ``inv``
    (inside the kernel; with torch ops in the plain version)."""
    from raytracedggx_tpu_torch.ops.traverse_cuda import trace_stream_plain

    def kern(stats=None):
        return kernel(tree, o, d, t_min, t_max, inv, stats)

    def plain():
        return trace_stream_plain(tree.tris, o, d, t_min, t_max, inv)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = hold_hits(name, (got[0], got[3], None), (ref[0], ref[3], None),
                    t_max)
    stats = torch.zeros(2, dtype=torch.int64, device=o.device)
    kern(stats)
    # the (N, 9 | 36) node and (T, 9) triangle rows, not the float4 copies
    bound_ms, bound_by = trace_bound((tree.nodes, tree.tris, inv, o, d, t_max),
                                     o.shape[0], 16, stats)
    ms, plain_ms = time_pair(name, kern, plain)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def per_mesh_wave_check(label, trees, o, d, t_min, t_max, inv):
    """K4 and K5 on one full wave of the frame in the model instance's
    object space (through the inverse world, as trace_scene_flat /
    trace_scene4 launch them), against one run of the plain version over
    the whole wave, compared by original triangle id.  trees: {"K4" |
    "K5": (tree, wrapper)}; returns {"K4" | "K5": dict(max_abs_err, ms,
    plain_ms, bound_ms, bound_by)}."""
    from raytracedggx_tpu_torch.ops.traverse_cuda import trace_stream_plain

    flat = trees["K4"][0]
    ref, plain_ms = timed_once(lambda: trace_stream_plain(
        flat.tris, o, d, t_min, t_max, inv))
    r_id = torch.where(ref[3] >= 0, flat.tri_perm[ref[3].clamp(min=0).long()],
                       -1)
    rows = {}
    for key, (tree, kernel) in trees.items():
        name = f"{key} {label}"

        def kern(stats=None):
            return kernel(tree, o, d, t_min, t_max, inv, stats)

        got = kern()
        torch.cuda.synchronize()
        g_id = torch.where(got[3] >= 0,
                           tree.tri_perm[got[3].clamp(min=0).long()], -1)
        err = hold_hits(name, (got[0], g_id, None), (ref[0], r_id, None),
                        t_max)
        stats = torch.zeros(2, dtype=torch.int64, device=o.device)
        kern(stats)
        # the bytes the function needs: the (N, 9 | 36) node and (T, 9)
        # triangle rows (the kernels' float4 copies only pad them)
        bound_ms, bound_by = trace_bound(
            (tree.nodes, tree.tris, inv, o, d, t_max), o.shape[0], 16, stats)
        ms = cuda_ms(kern, 20)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})")
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return rows


def scene_loop_check(name, trees, scene_fn, tlas, o, d, t_max):
    """The per-instance loop (trace_scene_flat / trace_scene4) with the
    kernel against the same loop over the plain version."""
    def run(impl):
        return scene_fn(trees, tlas, o, d, 0.0, t_max, impl=impl)

    got, ref = run("cuda"), run("xla")
    torch.cuda.synchronize()
    err = hold_hits(name, (got.t, got.prim, got.inst),
                    (ref.t, ref.prim, ref.inst), t_max)
    time_pair(name, lambda: run("cuda"), lambda: run("xla"))
    return err


def valid_taps(along, across):
    """In-image taps of one 33-tap pass over an image ``along`` pixels
    long in the pass axis and ``across`` wide."""
    x = np.arange(along)
    per_x = np.minimum(x + 16, along - 1) - np.maximum(x - 16, 0) + 1
    return int(per_x.sum()) * across


def spatial_check(aux_out, width, height):
    """K2 and K3 against their plain versions on a frame's G-buffers,
    both axes, each timed with its bound; returns {name: dict(max_abs_err,
    ms, plain_ms, bound)} with the row pass's times."""
    from raytracedggx_tpu_torch.denoise import tm
    from raytracedggx_tpu_torch.ops.spatial_cuda import (
        diffuse_pass, diffuse_pass_plain, reflection_pass,
        reflection_pass_plain)

    normal, depth = aux_out["normal"], aux_out["depth"]
    rough = aux_out["rough_metal"][..., 0].contiguous()
    metal = aux_out["rough_metal"][..., 1].contiguous()
    hit = normal[..., 3:4] > 0
    gate = hit & (metal[..., None] < 1.0)
    check(bool(gate.any()), "the frame has live diffuse pixels for K3")
    res = {}
    # fp32 operations per in-image tap, counted in csrc/spatial.cu: normal
    # dot 5, clip 2, depth weight 5, accumulate 7; K2 adds pow 7, the
    # roughness weight 10 and 3 products (its Gaussian is a table read, its
    # gate folded into the staged normal): 39; K3 adds pow 5 and 1 product
    # (PR 1 counted 46 and 30 for the kernels that decoded and divided per
    # tap)
    cases = {
        "K2": (tm(aux_out["refl"]).contiguous(), hit, rough, 39,
               lambda s, ax: reflection_pass(s, normal, rough, depth, width,
                                             height, ax),
               lambda s, ax: reflection_pass_plain(s, normal, rough, depth,
                                                   width, height, ax)),
        "K3": (tm(aux_out["diff"]).contiguous(), gate, metal, 25,
               lambda s, ax: diffuse_pass(s, normal, metal, depth, ax),
               lambda s, ax: diffuse_pass_plain(s, normal, metal, depth, ax)),
    }
    for name, (src, mask, aux, tap_ops, kern, plain) in cases.items():
        h_ref = plain(src, 1)
        h_src = torch.where(mask, h_ref, 0.0).contiguous()
        errs = []
        nbytes = sum(t.numel() * t.element_size()
                     for t in (src, normal, aux, depth, src))
        for ax, s in ((1, src), (0, h_src)):
            got, ref = kern(s, ax), plain(s, ax)
            err = (got - ref).abs()
            ok = bool((err <= 2e-5 + 1e-4 * ref.abs()).all())
            errs.append(float(err.max()))
            check(ok, f"{name} axis {ax}: atol 2e-5 rtol 1e-4 (max err "
                  f"{errs[-1]:.3e})")
            ms, plain_ms = time_pair(f"{name} axis {ax} one pass",
                                     lambda: kern(s, ax), lambda: plain(s, ax),
                                     plain_reps=5)
            along, across = (width, height) if ax == 1 else (height, width)
            bound_ms, bound_by = bound(nbytes,
                                       tap_ops * valid_taps(along, across))
            print(f"    bound {bound_ms:.6f} ms ({bound_by})")
            if ax == 1:
                res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
        res[name]["max_abs_err"] = max(errs)
    return res


def xform_check(rng, device, n=W * H, reps=20):
    """XF against its plain version (take_small + einsum) at the frame's
    n rays, in each of the waves' three forms, on a 2-row table, ids in
    [-1, 2) and x as the columns of wider rows (a wave's un-permuted
    rows): within 2 float32 ulp of the operands' magnitude (tests/
    test_torch_cuda.py).  Times the kernel, the plain version and the
    library's share of it (the cuBLAS einsum on the gathered matrices);
    bound: the ids, x and the output, each once.  Returns the affine
    (object to world) form's dict(max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by), the error of all."""
    from raytracedggx_tpu_torch.ops.xform_cuda import (instance_xform,
                                                       instance_xform_plain)
    from raytracedggx_tpu_torch.trace.shade import take_small

    forms = {"to_object": (4, True, None), "normal": (3, False, None),
             "clip": (4, True, 4)}
    ids = torch.as_tensor(rng.integers(-1, 2, (n, 2)), device=device)[:, 1]
    xw = torch.as_tensor(rng.normal(0.0, 5.0, (n, 6)), dtype=torch.float32,
                         device=device)
    x = xw[:, 3:6]
    rows, errs = {}, []
    for form, (t, affine, cols) in forms.items():
        table = torch.as_tensor(rng.normal(0.0, 2.0, (2, t, t)),
                                dtype=torch.float32, device=device)
        got = instance_xform(table, ids, x, affine, cols)
        ref = instance_xform_plain(table, ids, x, affine, cols)
        m = take_small(table, ids)
        d = got.shape[1]
        mag = torch.einsum("nc,ncd->nd", x.abs(), m[:, :3, :d].abs())
        if affine:
            mag = mag + m[:, 3, :d].abs()
        err = (got - ref).abs()
        errs.append(float(err.max()))
        check(bool((err <= 2.0 * F32_EPS * mag).all()),
              f"XF {form}: {n} rays within 2 ulp of the operands' magnitude"
              f" (max |err| {errs[-1]:.3e}, max err / magnitude "
              f"{float((err / mag.clamp(min=1e-30)).max()):.3e})")
        ms, plain_ms = time_pair(f"XF {form}",
                                 lambda: instance_xform(table, ids, x, affine,
                                                        cols),
                                 lambda: instance_xform_plain(table, ids, x,
                                                              affine, cols),
                                 kern_reps=reps, plain_reps=reps)
        mats = m[:, :3, :d].contiguous()
        library_ms = cuda_ms(lambda: torch.einsum("...c,...cd->...d", x,
                                                  mats), reps)
        # the ids, x and the output once; at most 4 FMAs an output
        nbytes = n * (ids.element_size() + 3 * 4 + d * 4)
        bound_ms, bound_by = bound(nbytes, n * d * 8)
        print(f"    library (einsum on gathered matrices) {library_ms:.4f} "
              f"ms; bound {bound_ms:.6f} ms ({bound_by}), kernel at "
              f"{100 * bound_ms / ms:.1f}% of it")
        rows[form] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return dict(rows["to_object"], max_abs_err=max(errs))


def ts_inputs(rng, h, w, device, hist_dtype=torch.float16, motion=0.002):
    """TS's inputs as a frame hands them over (the pattern of
    tests/test_torch_cuda.py:_ts_inputs): HDR colour whose alpha, the hit
    flag, is 1 inside an ellipse and 0 outside; velocities of ``motion``
    viewports, one pixel in 64 thrown up to 1.5 viewports (past every
    border); a history with counts k / 15; NaN in one history pixel in
    4096 and one more (the result's NaN fallback), and in one colour
    value."""
    cur = rng.uniform(0.0, 4.0, (h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    cur[..., 3] = (((yy - h / 2) / (0.4 * h)) ** 2
                   + ((xx - w / 2) / (0.4 * w)) ** 2) < 1.0
    vel = rng.normal(0.0, motion, (h, w, 2)).astype(np.float32)
    far = rng.random((h, w)) < 1 / 64
    vel[far] = rng.uniform(-1.5, 1.5, (int(far.sum()), 2))
    hist = rng.uniform(0.0, 4.0, (h, w, 4)).astype(np.float32)
    hist[..., 3] = rng.integers(0, 16, (h, w)) / 15.0
    hist[rng.random((h, w)) < 1 / 4096, 1] = np.nan
    hist[h // 4, w // 4, 1] = np.nan
    cur[h // 2, w // 2, 0] = np.nan
    return (torch.as_tensor(cur, device=device),
            torch.as_tensor(hist, device=device).to(hist_dtype),
            torch.as_tensor(vel, device=device))


def ts_differ(got, ref):
    """Elements of two float32 tensors that differ in their bits (a NaN
    equals a NaN)."""
    same = (got.view(torch.int32) == ref.view(torch.int32)) \
        | (got.isnan() & ref.isnan())
    return int((~same).sum())


def ts_check(rng, device, reps=20):
    """TS against its plain version (denoise/temporal.py:temporal_ss) on
    the card, bit for bit: at 1280x720 and 3840x2160 with the frame's f16
    history (``ts_inputs``), at 67x37 with an f32 history, and as a band
    of 37 rows from row -5 of a 47-row image with its velocity a strided
    view.  Times the kernel and the plain version at both frame sizes;
    bound: 40 B a pixel (colour, velocity and the f16 history read, the
    f16 history written) and ~150 operations.  Returns the 1280x720 row
    dict(max_abs_err, ms, plain_ms, bound_ms, bound_by) and the 4K row's
    under "4k"."""
    from raytracedggx_tpu_torch.denoise.temporal import temporal_ss as plain
    from raytracedggx_tpu_torch.ops.temporal_cuda import temporal_ss

    rows = {}
    for label, h, w, dtype in (("720p", H, W, torch.float16),
                               ("4k", 2160, 3840, torch.float16),
                               ("67x37 f32", 37, 67, torch.float32)):
        cur, hist, vel = ts_inputs(rng, h, w, device, dtype)
        n0 = temporal_ss.launches
        got, ref = temporal_ss(cur, hist, vel), plain(cur, hist, vel)
        torch.cuda.synchronize()
        check(temporal_ss.launches == n0 + 1, f"TS {label}: one launch")
        n = ts_differ(got, ref)
        err = float((got - ref).abs().nan_to_num(0.0).max())
        check(n == 0, f"TS {label}: {h * w} pixels bit for bit the plain "
              f"version ({n} values differ, max |diff| {err:.3e}; "
              f"{int(ref.isnan().any(-1).sum())} NaN pixels on both)")
        if h * w < 10000:
            continue
        ms, plain_ms = time_pair(f"TS {label}",
                                 lambda: temporal_ss(cur, hist, vel),
                                 lambda: plain(cur, hist, vel),
                                 kern_reps=reps, plain_reps=3)
        bound_ms, bound_by = bound(h * w * 40, h * w * 150)
        print(f"    bound {bound_ms:.6f} ms ({bound_by}), kernel at "
              f"{100 * bound_ms / ms:.1f}% of it")
        rows[label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    cur, hist, vel = ts_inputs(rng, 37, 67, device, motion=0.1)
    vel = torch.cat([vel, vel], dim=-1)[..., 1:3]
    for row0 in (-5, 10):
        got = temporal_ss(cur, hist, vel, full_size=(67, 47), row0=row0)
        ref = plain(cur, hist, vel, full_size=(67, 47), row0=row0)
        n = ts_differ(got, ref)
        check(n == 0, f"TS band from row {row0} of 47, strided velocity: "
              f"bit for bit ({n} values differ)")
    return dict(rows["720p"], **{"4k": rows["4k"]})


def bs_check(renderer, dev, reps=20):
    """BS against its plain version (ops/shade_cuda.py:shade_bounce_plain)
    on the card, bit for bit, on the frame's sorted bounce waves as K1
    hands them over: the model scene at 1280x720 (``renderer``) and over 8
    instances at 3840x2160 (the 4K cell's layout), each at metallic 1 and
    0.5 (the reflection wave, then the damped diffuse wave too).  Times
    the kernel and the plain version on each size's reflection wave;
    bound: 65 B a ray (origin, direction, t, id, hit flag and normal read,
    the (R, 4) row written; the env rows from L2).  Returns the 1280x720
    row dict(max_abs_err, ms, plain_ms, bound_ms, bound_by) and the 4K
    row's under "4k"."""
    import raytracedggx_tpu_torch.trace.raygen as raygen
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.ops import shade_cuda
    from raytracedggx_tpu_torch.scene import Scene

    scene = renderer.scene
    extra = tuple((2.5 * (i % 3) - 2.5, 0.0, 2.5 * (i // 3) - 2.5, 0.6)
                  for i in range(1, 7))
    r4k = Renderer(Scene(meshes=scene.meshes, materials=scene.materials,
                         pos_scale=scene.pos_scale, extra_instances=extra),
                   config=RenderConfig(width=3840, height=2160), device=dev)
    calls, real = [], raygen.shade_bounce

    def spy(*args):
        calls.append(args)
        return real(*args)
    rows = {}
    raygen.shade_bounce = spy
    try:
        for label, r in (("720p", renderer), ("4k", r4k)):
            for metallic in (1.0, 0.5):
                for mesh_idx in (0, 1):
                    r.set_metallic(mesh_idx, metallic)
                calls.clear()
                n0 = shade_cuda.shade_bounce.launches
                r.step(r.init_state())
                torch.cuda.synchronize()
                want = 2 if metallic < 1.0 else 1
                check(len(calls) == want
                      and shade_cuda.shade_bounce.launches == n0 + want,
                      f"BS {label} metallic {metallic:g}: {want} launch(es)")
                for args in calls:
                    got = shade_cuda.shade_bounce(*args)
                    ref = shade_cuda.shade_bounce_plain(*args)
                    n = ts_differ(got, ref)
                    rec = args[4]
                    check(n == 0, f"BS {label} metallic {metallic:g} "
                          f"{'diffuse' if args[-1] else 'reflection'} wave: "
                          f"{got.shape[0]} rays ({int(rec.hit.sum())} hits) "
                          f"bit for bit the plain version ({n} values "
                          f"differ)")
                if metallic == 1.0:
                    args = calls[0]
                    ms, plain_ms = time_pair(
                        f"BS {label} reflection wave",
                        lambda: shade_cuda.shade_bounce(*args),
                        lambda: shade_cuda.shade_bounce_plain(*args),
                        kern_reps=reps, plain_reps=3)
                    n_rays = args[6].shape[0]
                    bound_ms, bound_by = bound(n_rays * 65, n_rays * 300)
                    print(f"    bound {bound_ms:.6f} ms ({bound_by}), kernel "
                          f"at {100 * bound_ms / ms:.1f}% of it")
                    rows[label] = dict(max_abs_err=0.0, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
    finally:
        raygen.shade_bounce = real
    for mesh_idx in (0, 1):
        renderer.set_metallic(mesh_idx, 1.0)
    del r4k
    return dict(rows["720p"], **{"4k": rows["4k"]})


# ---------------------------------------------------------------- phase 4
def zero_counts():
    from raytracedggx_tpu_torch.engine.renderer import launch_counters

    for _, fn, attr in launch_counters():
        setattr(fn, attr, 0)


def read_counts():
    """The launch counts in COUNTED's order."""
    from raytracedggx_tpu_torch.engine.renderer import launch_counts

    counts = launch_counts()
    return [counts[k] for k in COUNTED]


def drive_path(renderer, label, timed, metal_frames, per_frame,
               per_frame_metal, card):
    """One path at its config: 3 warm-up frames, then ``timed`` frames and
    ``metal_frames`` at metallic 0.5 between CUDA events, with every
    launch count set to 0 just before and read just after.  per_frame:
    the expected launches per frame of each part, in COUNTED's order."""
    state = renderer.init_state()
    for _ in range(3):
        state, frame, aux = renderer.step(state)
    hit = aux["normal"][..., 3] > 0.5
    metal = aux["rough_metal"][..., 1]
    rays = W * H + int(hit.sum()) + int((hit & (metal < 1.0)).sum())
    torch.cuda.synchronize()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        state, frame, _ = renderer.step(state)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / timed
    counts = read_counts()
    print(f"  {label}: {ms:.4f} ms/frame, {rays} live rays/frame, "
          f"{rays / ms / 1e3:.4f} Mrays/s over {timed} frames ({card})")
    f = frame.float()
    check(bool(torch.isfinite(f).all()) and float(f.std()) > 1e-3,
          f"{label}: frame finite and not constant (std {float(f.std()):.4f})")
    check(counts == [n * timed for n in per_frame],
          f"{label}: launches {'/'.join(COUNTED)} {counts} = {per_frame} "
          f"per frame")

    for mesh_idx in (0, 1):
        renderer.set_metallic(mesh_idx, 0.5)
    start.record()
    for _ in range(metal_frames):
        state, frame, _ = renderer.step(state)
    end.record()
    end.synchronize()
    ms_metal = start.elapsed_time(end) / metal_frames
    total = read_counts()
    delta = [a - b for a, b in zip(total, counts)]
    print(f"  {label} metallic 0.5: {ms_metal:.4f} ms/frame over "
          f"{metal_frames} frames ({card})")
    f = frame.float()
    check(bool(torch.isfinite(f).all()) and float(f.std()) > 1e-3,
          f"{label}: metallic 0.5 frame finite and not constant")
    check(delta == [n * metal_frames for n in per_frame_metal],
          f"{label}: launches {'/'.join(COUNTED)} {delta} = "
          f"{per_frame_metal} per frame at metallic 0.5")
    return dict(ms=ms, ms_metal=ms_metal, rays=rays, launches=total)


def kernels_switch_check(scene, dev, card, frames=3):
    """kernels="xla" swaps only the spatial filters for their plain
    passes: "wide" frames still launch K1 (2 per frame) and no K2 or K3;
    set_kernels("auto") brings K2 back from the next frame on.  Counts in
    COUNTED's order."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer

    r = Renderer(scene, config=RenderConfig(width=W, height=H,
                                            kernels="xla"), device=dev)
    state, _, _ = r.step(r.init_state())
    torch.cuda.synchronize()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        state, frame, _ = r.step(state)
    end.record()
    end.synchronize()
    counts = read_counts()
    print(f"  wide, kernels='xla': {start.elapsed_time(end) / frames:.4f} "
          f"ms/frame over {frames} frames ({card})")
    f = frame.float()
    check(bool(torch.isfinite(f).all()) and float(f.std()) > 1e-3,
          "kernels='xla': frame finite and not constant")
    want = [2, 0, 0, 0, 0, 0, 0, 0, 4, 1, 1]
    check(counts == [n * frames for n in want], f"kernels='xla': launches "
          f"{'/'.join(COUNTED)} {counts} = {want} per frame")
    r.set_kernels("auto")
    zero_counts()
    r.step(state)
    counts = read_counts()
    want = [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1]
    check(counts == want, f"set_kernels('auto'): launches "
          f"{'/'.join(COUNTED)} {counts} = {want} in the next frame")


def knob_paths(scene, dev, card, width=W, height=H):
    """The renderer's knobs on "wide" beside the default frame,
    each renderer fresh: 3 warm-up frames each, then KNOB_TIMED frames in
    two halves in the order default, slim, dir6, dir6, slim, default,
    then KNOB_METAL at metallic 0.5, every block between CUDA events with
    the launch counts set to 0 just before and read just after.  Every
    frame is held against the default frame of the same step at the
    golden bar (max 0.02, mean 0.002).  Returns {path: dict(ms, ms_metal,
    max_diff, mean_diff, identical, launches)}."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer

    size = dict(width=width, height=height)
    paths = {  # config, launches per frame, and at metallic 0.5
        "default": (RenderConfig(**size), [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1],
                    [3, 0, 0, 0, 2, 2, 0, 0, 4, 1, 2]),
        "trace_slim": (RenderConfig(trace_slim=True, **size),
                       [0, 2, 0, 2, 2, 0, 0, 0, 4, 1, 1],
                       [0, 3, 0, 3, 2, 2, 0, 0, 4, 1, 2]),
        "sort_dir_bits": (RenderConfig(sort_dir_bits=6, **size),
                          [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1],
                          [3, 0, 0, 0, 2, 2, 0, 0, 4, 1, 2]),
    }
    rs, states, frames, ms = {}, {}, {}, {}
    launches = {k: [0] * len(COUNTED) for k in paths}
    for k, (cfg, _, _) in paths.items():
        t0 = time.perf_counter()
        rs[k] = Renderer(scene, config=cfg, device=dev)
        states[k] = rs[k].init_state()
        for _ in range(3):
            states[k], _, _ = rs[k].step(states[k])
        torch.cuda.synchronize()
        print(f"  {k}: set-up and 3 warm-up frames "
              f"{time.perf_counter() - t0:.3f} s")
        frames[k], ms[k] = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def block(k, n, per_frame):
        zero_counts()
        start.record()
        for _ in range(n):
            states[k], frame, _ = rs[k].step(states[k])
            frames[k].append(frame)
        end.record()
        end.synchronize()
        counts = read_counts()
        check(counts == [c * n for c in per_frame], f"{k}: launches "
              f"{'/'.join(COUNTED)} {counts} = {per_frame} per frame")
        launches[k] = [a + b for a, b in zip(launches[k], counts)]
        return start.elapsed_time(end) / n

    half = KNOB_TIMED // 2
    for k in list(paths) + list(paths)[::-1]:
        ms[k].append(block(k, half, paths[k][1]))
    ms_metal = {}
    for k in paths:
        for mesh_idx in (0, 1):
            rs[k].set_metallic(mesh_idx, 0.5)
        ms_metal[k] = block(k, KNOB_METAL, paths[k][2])
    res = {}
    for k in paths:
        res[k] = dict(ms=float(np.mean(ms[k])), ms_metal=ms_metal[k],
                      launches=launches[k])
        print(f"  {k}: {res[k]['ms']:.4f} ms/frame (halves "
              f"{ms[k][0]:.4f}, {ms[k][1]:.4f}) over {KNOB_TIMED} frames, "
              f"metallic 0.5 {ms_metal[k]:.4f} ms/frame over {KNOB_METAL} "
              f"({card})")
        f = frames[k][-1].float()
        check(bool(torch.isfinite(f).all()) and float(f.std()) > 1e-3,
              f"{k}: frame finite and not constant")
        if k == "default":
            continue
        diffs = [(a.clamp(0, 1) - b.clamp(0, 1)).abs()
                 for a, b in zip(frames[k], frames["default"])]
        worst = max(float(x.max()) for x in diffs)
        mean = max(float(x.mean()) for x in diffs)
        same = sum(bool((x == 0).all()) for x in diffs)
        res[k].update(max_diff=worst, mean_diff=mean, identical=same)
        check(worst < 0.02 and mean < 0.002, f"{k}: each of {len(diffs)} "
              f"frames against the default frame of its step, max diff "
              f"{worst:.6g} < 0.02, mean at most {mean:.6g} < 0.002; "
              f"{same} frames identical")
    return res


def fat_path_check(renderer, worlds, waves):
    """K1f through its API path: build_scene_wide(lean=False) and
    trace_scene_wide_fused over the frame's two waves, FAT_REPS times,
    with the launch counts set to 0 just before and read just after (K1f
    twice per pass, nothing else), its results held against the lean
    tree's on the same waves: hit mask, prim, inst, u and v exact, t at
    rtol 1e-6, the normal at atol 1e-5.  Returns K1f's launches."""
    from raytracedggx_tpu_torch.ops.scene_wide import (build_scene_wide,
                                                       refit_scene_wide,
                                                       trace_scene_wide_fused)

    sw = renderer.swide
    sw_f = build_scene_wide(renderer.geom, renderer.scene.mesh_ids,
                            leaf_size=sw.leaf_size, worlds=worlds,
                            device=renderer.device, lean=False)
    sw_l = refit_scene_wide(sw, worlds)
    torch.cuda.synchronize()
    zero_counts()
    for _ in range(FAT_REPS):
        outs = [trace_scene_wide_fused(sw_f, *w) for w in waves]
    torch.cuda.synchronize()
    counts = read_counts()
    want = [0, 0, 2 * FAT_REPS, 0, 0, 0, 0, 0, 0, 0, 0]
    check(counts == want, f"K1f API path: launches {'/'.join(COUNTED)} "
          f"{counts} = {want} over {FAT_REPS} passes of both waves")
    for label, w, (rec, nrm) in zip(("primary", "reflection"), waves, outs):
        ref, n_ref = trace_scene_wide_fused(sw_l, *w)
        h = ref.hit
        same = bool((rec.hit == h).all() and (rec.prim == ref.prim).all()
                    and (rec.inst == ref.inst).all())
        dt = float((rec.t - ref.t).abs().max())
        same_uv = torch.equal(rec.u, ref.u) and torch.equal(rec.v, ref.v)
        dn = float((nrm - n_ref)[h].abs().max()) if h.any() else 0.0
        check(same and same_uv and bool(((rec.t - ref.t).abs()
                                         <= 1e-6 * ref.t.abs()).all())
              and dn <= 1e-5,
              f"K1f API path, {label} wave: {int(h.sum())} hits, hit mask, "
              f"prim, inst, u and v exact, t at rtol 1e-6 (max |dt| "
              f"{dt:.3e}), normal at atol 1e-5 (max {dn:.3e}) of the lean "
              f"tree's")
    return counts[2]


# ---------------------------------------------------------------- phase 5
def read_png(path):
    """8-bit RGB PNG, filter 0 on every row (what the golden writer
    emits) -> (H, W, 3) float32 in [0, 1]."""
    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        typ, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if typ == b"IHDR":
            w, h = int.from_bytes(body[0:4], "big"), int.from_bytes(
                body[4:8], "big")
            if body[8:10] != b"\x08\x02":
                raise ValueError("golden PNG is not 8-bit RGB")
        elif typ == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("golden PNG uses row filters")
    return raw[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0


def golden_check(device, traversal="auto", ndc_fmt=False):
    """3 frames of the 96x54 cube scene against the JAX package's PNG:
    the default frame (mean < 3e-3), or bary_mode="ndc" with
    emulate_formats (tests/test_golden.py:174-176)."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.scene import Scene, default_materials, \
        ground_cube

    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0, 3.0, 0, 1.0], np.float32))
    extra = dict(bary_mode="ndc", emulate_formats=True) if ndc_fmt else {}
    r = Renderer(scene, config=RenderConfig(width=96, height=54,
                                            traversal=traversal, **extra),
                 device=device)
    state, frame = r.run_frames(3)
    got = frame.clamp(0, 1).cpu().numpy()
    diff = np.abs(got - read_png(GOLDEN_NDC_FMT if ndc_fmt else GOLDEN))
    mean = float(diff.mean())
    frac = float((diff.max(axis=-1) > 0.05).mean())
    label = (f"golden 96x54 f3{' ndc+formats' if ndc_fmt else ''} "
             f"({traversal})")
    print(f"  {label}: mean {mean:.6f}, max {float(diff.max()):.6f}, "
          f"pixels > 0.05: {frac:.6f}")
    check(mean < (2e-3 if ndc_fmt else 3e-3),
          f"{label}: mean diff < {'2e-3' if ndc_fmt else '3e-3'}")
    check(frac < 2e-3, f"{label}: fewer than 0.2% of pixels off by > 0.05")
    check(state.history.dtype == torch.float16, "TAA history stays f16")


# ---------------------------------------------------------------- phase 6
def lab_counters():
    """The launch counters of K6a, K6b and K7, in that order."""
    from raytracedggx_tpu_torch.ops.lab import fused_lab, fused_mxu

    return (fused_lab.lab_kernel, fused_lab.ls_kernel,
            fused_mxu.trace_tiles_mxu)


def timed_once(fn):
    """(fn(), its milliseconds between CUDA events) from one run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lab_check(bench, name, kw, o, d, t_max):
    """One kernel-lab variant against its plain version on the check rays,
    from kbench's reflection t_min: the traversal bar, and for K6a / K6b
    per-ray node and leaf visits equal on >= 99% of rays (fmad rounding
    may flip a box test at its edge) and no push onto a full stack; kernel
    and plain ms, and the bound."""
    from raytracedggx_tpu_torch.scripts.kbench import T_MIN_REFL, kernel_of

    kernel = kernel_of(kw)
    label = f"{kernel} {name}"
    s, _ = bench.variant_tree(kw)
    ref, plain_ms = timed_once(lambda: bench.plain(kw, o, d, t_max,
                                                   T_MIN_REFL))
    lab = kernel != "K7"
    got = bench.launch(kw, o, d, t_max, stats=True if lab else None,
                       t_min=T_MIN_REFL)
    torch.cuda.synchronize()
    i, j = (4, 5) if lab else (3, 4)
    err = hold_hits(label, (got[0], got[i], got[j]), (ref[0], ref[i], ref[j]),
                    t_max)
    if lab:
        same = float((got[6] == ref[6][:, :2]).all(dim=1).float().mean())
        check(same >= 0.99, f"{label}: node and leaf visits equal on "
              f"{same:.5f} of rays")
        depth, cap = int(ref[6][:, 2].max()), bench.stack(s, kw)
        check(depth < cap, f"{label}: deepest stack {depth} < {cap}, no "
              f"push dropped")
    bound_ms, bound_by = lab_bound(bench, kw, o, d, t_max, T_MIN_REFL)
    ms = cuda_ms(lambda: bench.launch(kw, o, d, t_max,
                                     t_min=T_MIN_REFL), 20)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def lab_bound(bench, kw, o, d, t_max, t_min):
    """The bound of one launch of a kernel-lab variant on rays (o, d,
    t_max) from t_min: its inputs read once, its outputs written once, and
    the box and triangle (K7: slot) tests it counts on these rays."""
    from raytracedggx_tpu_torch.scripts.kbench import kernel_of

    s, L = bench.variant_tree(kw)
    totals = torch.zeros(2, dtype=torch.int64, device=o.device)
    bench.launch(kw, o, d, t_max, totals=totals, t_min=t_min)
    if kernel_of(kw) != "K7":
        inputs = (s.nodes, s.tris, s.attrs, bench.boxes(s, kw), s.inv_mats,
                  o, d, t_max)
        out_bytes, tri_ops = 32 + (8 if kw.get("stats") else 0), TRI_OPS
    else:
        inputs = (s.nodes, bench.coef(s, L), s.inv_mats, o, d, t_max)
        out_bytes, tri_ops = 20, SLOT_OPS_MXU
    return trace_bound(inputs, o.shape[0], out_bytes, totals, tri_ops)


def kernel_lab(dev, rng, card):
    """Phase 6.  Returns ({K6a, K6b, K7: row of the JSON line}, launches
    of K6a, K6b and K7 over kbench's run)."""
    from raytracedggx_tpu_torch.ops.lab.fused_lab import (ls_stack_bound,
                                                          stack_bound)
    from raytracedggx_tpu_torch.scripts.kbench import (T_MIN_REFL,
                                                       VARIANT_KW, Bench,
                                                       kernel_of)

    t0 = time.perf_counter()
    bench = Bench(dev, W, H)
    for leaf in (8, 16, 32, 64):
        s = bench.tree(leaf)
        print(f"  leaf {leaf}: {s.num_nodes} nodes, depth {s.depth}, "
              f"reference stack {s.stack}, K1 stack bound {s.k1_stack}, "
              f"lab walk bound at npop 1 / 2 / 4 "
              f"{[stack_bound(s.depth, p) for p in (1, 2, 4)]}, K6b's "
              f"{ls_stack_bound(s.depth)}")
    torch.cuda.synchronize()
    print(f"  kbench sets at {W}x{H}: primary {bench.o_p.shape[0]}, "
          f"reflection live {int((bench.t_r > 0).sum())}; set-up "
          f"{time.perf_counter() - t0:.3f} s")
    n3 = K1_RAYS // 4
    o_r, d_r = rand_rays(rng, n3, dev)
    t_r = torch.where(torch.arange(n3, device=dev) % 2 == 0, 1e4, -1.0)
    o_all = torch.cat([bench.o_p, bench.o_r])
    d_all = torch.cat([bench.d_p, bench.d_r])
    t_all = torch.cat([bench.t_p, bench.t_r])
    pick = torch.as_tensor(rng.choice(o_all.shape[0], K1_RAYS - n3,
                                      replace=False), device=dev)
    o = torch.cat([o_r, o_all[pick]]).contiguous()
    d = torch.cat([d_r, d_all[pick]]).contiguous()
    t_max = torch.cat([t_r, t_all[pick]]).contiguous()
    rows, errs = {}, {}
    for name in LAB_VARIANTS:
        kw = VARIANT_KW[name]
        r = lab_check(bench, name, kw, o, d, t_max)
        k = kernel_of(kw)
        errs[k] = max(errs.get(k, 0.0), r["max_abs_err"])
        if LAB_ROWS[k] == name:
            rows[k] = r
    for k, r in rows.items():
        r["max_abs_err"] = errs[k]

    fns = lab_counters()
    for fn in fns:
        fn.launches = 0
    for name in LAB_VARIANTS:
        r = bench.run(name, VARIANT_KW[name], LAB_FRAMES)
        if "parity" in r:
            check(r["parity"] <= 1e-3, f"{name}: t within kbench's gate of "
                  f"K1 on the reflection set ({r['parity']:.2e}; {card})")
    counts = [fn.launches for fn in fns]
    check(all(n > 0 for n in counts), f"kernel lab: launches K6a/K6b/K7 "
          f"{counts} over kbench's run, each > 0")
    for name in ("mxu32", "mxu16"):
        t_min_zero_check(bench, name)
    # the bound of each row's variant on kbench's full sets, beside the
    # times kbench printed for them above
    for k, name in LAB_ROWS.items():
        for label, o, d, t_max, t_min in (
                ("primary", bench.o_p, bench.d_p, bench.t_p, 0.0),
                ("reflection", bench.o_r, bench.d_r, bench.t_r, T_MIN_REFL)):
            bound_ms, bound_by = lab_bound(bench, VARIANT_KW[name], o, d,
                                           t_max, t_min)
            print(f"  {k} {name} on the full {label} set: bound "
                  f"{bound_ms:.6f} ms ({bound_by})")
    return rows, counts


def t_min_zero_check(bench, name):
    """K7 (variant ``name``) and K1 on the variant's tree over kbench's
    reflection set from t_min 0: the rays on which they differ beyond
    kbench's gate, each of which must have its nearer t below kbench's
    T_MIN_REFL (a re-hit of the surface the ray starts on)."""
    from raytracedggx_tpu_torch.ops.fused import trace_tiles_instanced
    from raytracedggx_tpu_torch.scripts.kbench import (PARITY_BAR,
                                                       T_MIN_REFL,
                                                       VARIANT_KW)

    kw = VARIANT_KW[name]
    s, L = bench.variant_tree(kw)
    o, d, t_max = bench.o_r, bench.d_r, bench.t_r
    t7 = bench.launch(kw, o, d, t_max, t_min=0.0)[0]
    t1 = trace_tiles_instanced(s.nodes, s.tris4, s.inv_mats, s.inst_slots,
                               o, d, 0.0, t_max, L, s.k1_stack)[0]
    err = (t7 - t1).abs()
    gap = torch.minimum(err, err / torch.clamp(t1.abs(), min=1e-3))
    over = torch.nonzero(~(gap <= PARITY_BAR))[:, 0]
    near = torch.minimum(t7, t1)[over]
    k7_near = int((t7[over] < t1[over]).sum())
    print(f"  {name} against K1 from t_min 0: {over.numel()} of "
          f"{int((t_max >= 0).sum())} live reflection rays differ beyond "
          f"{PARITY_BAR:g}, the nearer t K7's on {k7_near} and K1's on "
          f"{over.numel() - k7_near}; nearer t at most "
          f"{float(near.max()) if near.numel() else 0.0:.6g}, "
          f"{int((near == 0).sum())} of them at t = 0")
    for i in over[~(near < T_MIN_REFL)][:8].tolist():
        print(f"    ray {i}: K7 t {float(t7[i]):.6g}, K1 t {float(t1[i]):.6g}")
    check(bool((near < T_MIN_REFL).all()), f"{name}: every ray where K7 "
          f"and K1 differ from t_min 0 has its nearer t below "
          f"{T_MIN_REFL:g} (a self-hit)")


# ---------------------------------------------------------------- phase 7
def capture_check(r, label, per_frame, per_frame_metal, frames=3,
                  metal_frames=2):
    """step_n against a step loop of the same renderer from the same
    state: at metallic 1, then across a set_metallic to 0.5 (the gates
    open: a new capture).  Each chunk's last frame, history and previous
    WVPs must equal the loop's bit for bit; the captured frame's launches
    (counted at capture) must be the path's, and the counters, set to 0
    just before the chunk, must read that times the warm-up and capture
    frames.  Then one replayed chunk under torch.profiler: its kernels by
    name must be the captured frame's times the frames.  Returns the
    captured frame's launches at metallic 1 and 0.5."""
    from raytracedggx_tpu_torch.engine.renderer import CAPTURE_WARMUP
    from raytracedggx_tpu_torch.scripts.kprofile import KERNELS, profiled

    check(r.captures, f"{label}: step_n captures")
    s_loop = s_chunk = r.init_state()
    got_all = []
    for n, metallic, want in ((frames, 1.0, per_frame),
                              (metal_frames, 0.5, per_frame_metal)):
        for mesh_idx in (0, 1):
            r.set_metallic(mesh_idx, metallic)
        for _ in range(n):
            s_loop, f_loop, _ = r.step(s_loop)
        torch.cuda.synchronize()
        zero_counts()
        s_chunk, f_chunk = r.step_n(s_chunk, n)
        counts = read_counts()
        torch.cuda.synchronize()
        same = (torch.equal(f_loop, f_chunk)
                and torch.equal(s_loop.history, s_chunk.history)
                and torch.equal(s_loop.prev_wvp, s_chunk.prev_wvp))
        check(same, f"{label} metallic {metallic:g}: step_n({n}) equals "
              f"{n} steps bit for bit (frame, history, previous WVPs)")
        got = [r.capture_launches[k] for k in COUNTED]
        got_all.append(got)
        check(got == want, f"{label} metallic {metallic:g}: launches per "
              f"captured frame {'/'.join(COUNTED)} {got} = {want}")
        check(counts == [g * (CAPTURE_WARMUP + 1) for g in got],
              f"{label} metallic {metallic:g}: counters {counts} = the "
              f"captured frame's over {CAPTURE_WARMUP} warm-up frames and "
              f"the capture")
        replays = 2
        events = profiled(lambda: r.step_n(s_chunk, replays), 1)[0]
        seen = {k: sum(1 for name, _, _ in events
                       if any(key in name for key in KERNELS[k]))
                for k in ("K1", "K2", "K3", "K4", "K5")}
        seen["K1e"] = sum(1 for name, _, _ in events
                          if "slim_uv_kernel" in name)
        seen["XF"] = sum(1 for name, _, _ in events
                         if "instance_xform_kernel" in name)
        seen["TS"] = sum(1 for name, _, _ in events
                         if "temporal_ss_kernel" in name)
        seen["BS"] = sum(1 for name, _, _ in events
                         if "bounce_shade_kernel" in name)
        by = dict(zip(COUNTED, got))
        expect = {"K1": by["K1"] + by["K1s"] + by["K1f"], "K1e": by["K1e"],
                  "K2": by["K2"], "K3": by["K3"], "K4": by["K4"],
                  "K5": by["K5"], "XF": by["XF"], "TS": by["TS"],
                  "BS": by["BS"]}
        expect = {k: v * replays for k, v in expect.items()}
        print(f"  {label} metallic {metallic:g}: {replays} replays under "
              f"torch.profiler, kernels by name {seen}")
        check(seen == expect, f"{label} metallic {metallic:g}: the replayed "
              f"chunk launched {expect} by name")
    return got_all


def loop_timing(r, card, metallic, frames=LOOP_FRAMES):
    """ms/frame of the eager step loop and of captured step_n chunks, in
    halves in the order eager, captured, captured, eager (CUDA events
    around each half of ``frames`` frames; the host's wall beside), then
    device busy ms/frame and idle share of each under torch.profiler
    (``frames`` frames: eager steps, or one step_n chunk)."""
    from raytracedggx_tpu_torch.scripts.kprofile import busy_us, profiled

    for mesh_idx in (0, 1):
        r.set_metallic(mesh_idx, metallic)
    box = {"state": r.init_state()}

    def eager():
        for _ in range(frames):
            box["state"], _, _ = r.step(box["state"])

    def captured():
        box["state"], _ = r.step_n(box["state"], frames)

    runs = {"eager": eager, "captured": captured}
    for fn in runs.values():
        fn()                                    # warm-up (and capture)
    res = {k: dict(ms=[], wall=[]) for k in runs}
    for kind in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        runs[kind]()
        end.record()
        end.synchronize()
        res[kind]["wall"].append((time.perf_counter() - t0) * 1e3 / frames)
        res[kind]["ms"].append(start.elapsed_time(end) / frames)
    for kind, fn in runs.items():
        events, wall = profiled(fn, 1)
        busy = busy_us(events) / 1e3
        res[kind].update(busy_ms=busy / frames, idle=1.0 - busy / wall,
                         ops=len(events) / frames)
        print(f"  frame loop metallic {metallic:g}, {kind}: "
              f"{' / '.join(f'{x:.4f}' for x in res[kind]['ms'])} ms/frame "
              f"(halves; host wall "
              f"{' / '.join(f'{x:.4f}' for x in res[kind]['wall'])}); "
              f"device busy {res[kind]['busy_ms']:.4f} ms/frame, idle share "
              f"{res[kind]['idle']:.4f}, {res[kind]['ops']:.1f} device ops "
              f"per frame (profiler on; {card})")
    return res


def async_check(r):
    """async_compute on equals off bit for bit over 3 frames; one async
    frame under torch.profiler puts the constants' upload and the refit's
    operations on a stream other than K1's."""
    out = {}
    for on in (True, False):
        r.set_async_compute(on)
        state = r.init_state()
        for _ in range(3):
            state, frame, _ = r.step(state)
        out[on] = (state, frame)
    torch.cuda.synchronize()
    (sa, fa), (sb, fb) = out[True], out[False]
    check(torch.equal(fa, fb) and torch.equal(sa.history, sb.history),
          "async_compute on equals off bit for bit (3 frames)")
    r.set_async_compute(True)
    state, _, _ = r.step(r.init_state())
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # the tracer can lose the first device record after it starts (the
        # frame's upload, once on the H100): a marker op on the main
        # stream goes first, and is left out below
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        r.step(state)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name, e.device_resource_id) for e in prof.events()
           if e.device_type == cuda and "spin_kernel" not in e.name]
    k1 = {sid for name, sid in ops if "trace_instanced_kernel" in name}
    side = [(name, sid) for name, sid in ops if sid not in k1]
    streams = sorted({sid for _, sid in ops}, key=str)
    print(f"  async frame: {len(ops)} device operations on streams "
          f"{streams}; K1 on {sorted(k1, key=str)}; off K1's stream "
          f"{len(side)}: {sorted({name[:40] for name, _ in side})[:8]}")
    r.set_async_compute(False)
    check(len(k1) == 1 and any("Memcpy HtoD" in name for name, _ in side)
          and len(side) >= 5, "async_compute: the constants' upload and the "
          "refit run on a second stream")


def cli_check(dev, card):
    """The CLI on the card: the stand-in model written to an OBJ in a
    temporary directory; ``-mesh <obj> 0 1 0 1 --frames 8 --out <png>
    --stats --stage-times`` must exit 0 and its PNG equal the 8-bit image
    of the frame Renderer gives for the same config after 8 steps (async
    on, the CLI's default); ``--interactive`` with a command script must
    exit 0.  The two CLI processes run side by side while this process
    renders its frame, and all are waited for."""
    import shutil
    import tempfile

    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.io.png import tonemapped_u8
    from raytracedggx_tpu_torch.scene import Scene
    from raytracedggx_tpu_torch.scripts.standin import model_mesh, write_obj

    tmp = tempfile.mkdtemp(prefix="rtggx-cli-")
    procs = []
    try:
        obj = os.path.join(tmp, "model.obj")
        write_obj(obj, model_mesh())
        base = [sys.executable, "-m", "raytracedggx_tpu_torch.engine.cli",
                "-mesh", obj, "0", "1", "0", "1"]
        png = os.path.join(tmp, "cli.png")
        script = os.path.join(tmp, "commands.txt")
        with open(script, "w") as f:
            f.write(CLI_SCRIPT)
        t0 = time.perf_counter()
        for label, cmd, stdin in (
                ("frames", base + ["--frames", str(CLI_FRAMES), "--out", png,
                                   "--stats", "--stage-times"], os.devnull),
                ("interactive", base + ["--interactive", "--frames-per-cmd",
                                        "2", "--out",
                                        os.path.join(tmp, "i.png")],
                 script)):
            with open(stdin) as f:
                procs.append((label, subprocess.Popen(
                    cmd, cwd=ROOT, text=True, stdin=f,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        scene = Scene.create(obj, pos_scale=(0.0, 1.0, 0.0, 1.0))
        r = Renderer(scene, config=RenderConfig(async_compute=True),
                     device=dev)
        state = r.init_state()
        for _ in range(CLI_FRAMES):
            state, frame, _ = r.step(state)
        want = tonemapped_u8(frame.clamp(0, 1).cpu().numpy())
        for label, proc in procs:
            out, err = proc.communicate(timeout=600)
            for line in out.strip().splitlines()[-8:]:
                print(f"    | {line}")
            check(proc.returncode == 0, f"CLI {label} run exits 0 "
                  f"({time.perf_counter() - t0:.3f} s since both started; "
                  f"{err.strip()[-300:]})")
        got = np.round(read_png(png) * 255.0).astype(np.uint8)
        diff = int(np.abs(got.astype(np.int32) - want).max())
        check(got.shape == want.shape and diff == 0,
              f"CLI PNG equals Renderer's {CLI_FRAMES}th frame as 8 bits "
              f"(max |diff| {diff}; {card})")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def frame_loop(renderer, per_mesh, dev, card):
    """Phase 7: step_n's capture on every kernel path, async_compute,
    the eager and captured ms/frame, the CLI."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer

    t0 = time.perf_counter()
    capture_check(renderer, "wide", [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1],
                  [3, 0, 0, 0, 2, 2, 0, 0, 4, 1, 2])
    slim = Renderer(renderer.scene, config=RenderConfig(trace_slim=True),
                    device=dev)
    capture_check(slim, "wide trace_slim", [0, 2, 0, 2, 2, 0, 0, 0, 4, 1, 1],
                  [0, 3, 0, 3, 2, 2, 0, 0, 4, 1, 2])
    del slim
    capture_check(per_mesh["pallas4"], "pallas4", [0, 0, 0, 0, 2, 0, 0, 4, 5, 1, 0],
                  [0, 0, 0, 0, 2, 2, 0, 6, 6, 1, 0])
    capture_check(per_mesh["pallas"], "pallas", [0, 0, 0, 0, 2, 0, 4, 0, 5, 1, 0],
                  [0, 0, 0, 0, 2, 2, 6, 0, 6, 1, 0])
    t1 = time.perf_counter()
    async_check(renderer)
    timing = {m: loop_timing(renderer, card, m) for m in (1.0, 0.5)}
    t2 = time.perf_counter()
    cli_check(dev, card)
    print(f"  phase 7: captures {t1 - t0:.3f} s, async and timing "
          f"{t2 - t1:.3f} s, CLI {time.perf_counter() - t2:.3f} s")
    return timing


# ---------------------------------------------------------------- phase 8
def bench_check(dev, card):
    """Phase 8: the bench's configs in BENCH_CONFIGS as subprocesses, one
    after another (each times the card alone).  Returns {config: (record,
    launches {K1, K2, K3} over its run)}."""
    import re
    import shutil
    import tempfile

    from raytracedggx_tpu_torch.bench import CONFIGS, STANDIN_POS
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.engine.renderer import CAPTURE_WARMUP
    from raytracedggx_tpu_torch.scene import Scene
    from raytracedggx_tpu_torch.scripts.standin import model_mesh, write_obj

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RTGGX_BENCH")}
    env["RTGGX_BENCH_FRAMES"] = str(BENCH_FRAMES)
    tmp = tempfile.mkdtemp(prefix="rtggx-bench-check-")
    try:
        obj = os.path.join(tmp, "model.obj")
        write_obj(obj, model_mesh())
        scene = Scene.create(obj, pos_scale=STANDIN_POS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for cfg_id in BENCH_CONFIGS:
        c = CONFIGS[cfg_id]
        w, h = c["res"] or (W, H)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytracedggx_tpu_torch.bench"], cwd=ROOT,
            env=dict(env, RTGGX_BENCH_CONFIG=str(cfg_id)),
            capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        print(f"  config {cfg_id} ({time.perf_counter() - t0:.3f} s): "
              + " | ".join(lines))
        check(proc.returncode == 0 and len(lines) == 1,
              f"bench config {cfg_id}: exit 0 and one line "
              f"({proc.stderr.strip()[-300:]})")
        rec = json.loads(lines[0])
        metric = (f"mrays_per_s_per_chip_e2e_{w}x{h}"
                  + (f"_cfg{cfg_id}" if cfg_id else ""))
        check(set(rec) == {"metric", "value", "unit", "vs_baseline", "note"}
              and rec["metric"] == metric and rec["unit"] == "Mrays/s",
              f"bench config {cfg_id}: the keys and metric {metric}")
        check(rec["value"] > 0, f"bench config {cfg_id}: value "
              f"{rec['value']} > 0 (not the sentinel)")
        # the live rays of the first frame, recomputed in this process
        r = Renderer(scene, config=RenderConfig(width=w, height=h),
                     device=dev)
        if c.get("metallic") is not None:
            for mesh_idx in (0, 1):
                r.set_metallic(mesh_idx, c["metallic"])
        _, _, aux = r.step(r.init_state(), 1 / 60)
        hit = aux["normal"][..., 3] > 0.5
        metal = aux["rough_metal"][..., 1]
        rays = w * h + int(hit.sum()) + int((hit & (metal < 1.0)).sum())
        del r, aux
        note = rec["note"]
        got = int(re.search(r"live rays/frame (\d+)", note).group(1))
        check(got == rays, f"bench config {cfg_id}: live rays {got} = "
              f"{rays} of a step here")
        m = re.search(r"launches K1 (\d+) K2 (\d+) K3 (\d+) K4 (\d+) "
                      r"K5 (\d+) \(captured frame: K1 (\d+) K2 (\d+) K3 "
                      r"(\d+) K4 (\d+) K5 (\d+)\)", note)
        check(m is not None, f"bench config {cfg_id}: launches in the note")
        n = [int(x) for x in m.groups()]
        total, per = n[:5], n[5:]
        want = [3, 2, 2, 0, 0] if c.get("metallic") is not None \
            else [2, 2, 0, 0, 0]
        frames = 1 + CAPTURE_WARMUP + 1     # warm-up step, warm-up, capture
        check(per == want and total == [k * frames for k in per],
              f"bench config {cfg_id}: launches K1-K5 {total} = {frames} x "
              f"the captured frame's {per}")
        check(card in note, f"bench config {cfg_id}: the note names {card}")
        out[cfg_id] = (rec, dict(zip(("K1", "K2", "K3"), total)))
    return out


# ---------------------------------------------------------------- phase 9
def bands_check(scene, dev, card):
    """Phase 9: ShardedRenderer with BANDS bands on this card against
    Renderer.  Returns (launches {K1, K2, K3} of the band frames, ms/frame
    {halo 32, halo 16, single})."""
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.parallel import ShardedRenderer, make_row_mesh
    from raytracedggx_tpu_torch.scripts.sharded_bench import HALOS, paired

    cfg = RenderConfig(width=W, height=H)
    mesh = make_row_mesh((dev,) * BANDS)
    single = Renderer(scene, config=cfg, device=dev)
    bands = ShardedRenderer(scene, mesh=mesh, halo=BAND_HALO, config=cfg)
    band = H // BANDS
    check((bands.band, bands.halo) == (band, BAND_HALO),
          f"{BANDS} bands of {band} rows, halo {BAND_HALO}")
    launches = [0, 0, 0]
    for metallic, want in ((1.0, [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1]),
                           (0.5, [3, 0, 0, 0, 2, 2, 0, 0, 4, 1, 2])):
        for r in (single, bands):
            for mesh_idx in (0, 1):
                r.set_metallic(mesh_idx, metallic)
        counts = {}
        for label, r in (("single", single), ("bands", bands)):
            state = r.init_state()
            torch.cuda.synchronize()
            zero_counts()
            for _ in range(BAND_FRAMES):
                state, frame, _ = r.step(state)
            torch.cuda.synchronize()
            counts[label] = (read_counts(), state, frame)
        (c1, s1, f1), (c2, s2, f2) = counts["single"], counts["bands"]
        diff = float((f1 - f2).abs().max())
        exact = (torch.equal(f1, f2)
                 and torch.equal(s1.history, torch.cat(s2.history)))
        print(f"  metallic {metallic:g}: bands against the single-device "
              f"frame max |diff| {diff:.3e} over {BAND_FRAMES} frames (frame "
              f"and history bit for bit: {exact}); "
              f"launches {'/'.join(COUNTED)} single {c1}, bands {c2}")
        check(f2.shape == (H, W, 3) and diff < 5e-4,
              f"metallic {metallic:g}: the {BANDS}-band frame within one "
              f"f16 ulp (5e-4) of Renderer's")
        check(len(s2.history) == BANDS and all(
            b.shape == (band, W, 4) and b.dtype == torch.float16
            and b.device == dev for b in s2.history),
            f"metallic {metallic:g}: the history is {BANDS} bands of "
            f"({band}, {W}, 4) f16")
        check(c1 == [k * BAND_FRAMES for k in want]
              and c2 == [BANDS * k for k in c1],
              f"metallic {metallic:g}: the bands launch {BANDS}x the "
              f"single-device frame's {'/'.join(COUNTED)} ({want} per "
              f"frame)")
        launches = [a + c2[COUNTED.index(k)]
                    for a, k in zip(launches, ("K1", "K2", "K3"))]
    for r in (single, bands):
        for mesh_idx in (0, 1):
            r.set_metallic(mesh_idx, 1.0)
    starved = ShardedRenderer(scene, mesh=mesh, halo=1, config=cfg)
    frames = []
    for r in (single, starved, bands):
        state = r.init_state()
        for _ in range(FAST_FRAMES):
            state, frame, _ = r.step(state, FAST_DT)
        frames.append(frame)
    del starved
    d1 = float((frames[0] - frames[1]).abs().max())
    d_good = float((frames[0] - frames[2]).abs().max())
    print(f"  fast motion (dt {FAST_DT}, {FAST_FRAMES} frames): max |diff| "
          f"halo 1 {d1:.3e}, halo {BAND_HALO} {d_good:.3e}")
    check(d1 > 1e-3, "a starved halo of 1 differs from the single-device "
          "frame under fast motion")
    renderers = {f"halo {halo}": bands if halo == BAND_HALO else
                 ShardedRenderer(scene, mesh=mesh, halo=halo, config=cfg)
                 for halo in HALOS}
    renderers["single"] = single
    halves = paired(renderers, BAND_TIMED)
    print(f"  step loop ms/frame, halves of {BAND_TIMED // 2} frames: "
          + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
                      for k, v in halves.items())
          + f" ({BANDS} bands on one card; {card})")
    ms = {k: float(np.mean(v)) for k, v in halves.items()}
    return dict(zip(("K1", "K2", "K3"), launches)), ms


# ---------------------------------------------------------------- main
def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    print("== phase 0: machine")
    card = machine()

    print("== phase 1: build kernels")
    build_secs = build_kernels()

    print("== phase 2: scene")
    from raytracedggx_tpu_torch.bvh import build_tlas
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.ops.cuda_lib import load_library
    from raytracedggx_tpu_torch.ops.scene_wide import (refit_scene_wide,
                                                       trace_scene_wide_fused)
    from raytracedggx_tpu_torch.ops.traverse_cuda import (inv_rows,
                                                          trace_scene_flat,
                                                          trace_tiles_flat)
    from raytracedggx_tpu_torch.ops.wide import trace_scene4, trace_tiles4
    from raytracedggx_tpu_torch.scripts.kprofile import frame_waves
    from raytracedggx_tpu_torch.scripts.standin import (model_scene,
                                                        nested_scene)
    from raytracedggx_tpu_torch.trace.geometry import upload_scene

    t0 = time.perf_counter()
    scene = model_scene()
    renderer = Renderer(scene, device=dev)
    sw = renderer.swide
    n_tris = sum(m.num_triangles for m in scene.meshes)
    K1_MAX_STACK = load_library().rtggx_k1_max_stack()
    print(f"  triangles {n_tris}, stream slots {sw.tris.shape[0]}, leaves "
          f"{sw.tris.shape[0] // sw.leaf_size}, nodes {sw.num_nodes}, "
          f"K1 stack bound {sw.k1_stack} of {K1_MAX_STACK}, L "
          f"{sw.leaf_size}; renderer set-up "
          f"{time.perf_counter() - t0:.3f} s")
    per_mesh = {}
    for trav in ("pallas4", "pallas"):
        t0 = time.perf_counter()
        per_mesh[trav] = Renderer(scene, config=RenderConfig(traversal=trav),
                                  device=dev)
        torch.cuda.synchronize()
        print(f"  traversal={trav!r} renderer set-up "
              f"{time.perf_counter() - t0:.3f} s")
    model = scene.mesh_ids.index(1)
    flat = per_mesh["pallas"].geom.flat[1]
    wide = per_mesh["pallas4"].geom.wide[1]
    print(f"  model mesh at leaf 8: FlatBVH {flat.num_nodes} nodes, "
          f"{flat.pairs.shape[0]} pair rows, depth {flat.stack}; WideBVH "
          f"{wide.num_nodes} supernodes, stack bound {wide.stack}")

    print("== phase 3: kernels against their plain versions")
    rng = np.random.default_rng(1234)
    n3 = K1_RAYS // 4
    o_r, d_r = rand_rays(rng, n3, dev)
    t_r = torch.where(torch.arange(n3, device=dev) % 2 == 0, 1e4, -1.0)
    sw0, worlds_f, waves = frame_waves(renderer)   # scripts/kprofile.py
    check(len(waves) == 2 and all(w[0].shape[0] == W * H for w in waves),
          f"the frame's K1 waves: {[w[0].shape[0] for w in waves]} rays")
    o_f = torch.cat([w[0] for w in waves])
    d_f = torch.cat([w[1] for w in waves])
    t_f = torch.cat([w[3] for w in waves])
    pick = torch.as_tensor(rng.choice(o_f.shape[0], K1_RAYS - n3,
                                      replace=False), device=dev)
    o = torch.cat([o_r, o_f[pick]]).contiguous()
    d = torch.cat([d_r, d_f[pick]]).contiguous()
    t_max = torch.cat([t_r, t_f[pick]]).contiguous()
    o9, d9 = rand_rays(rng, K1_RAYS, dev)
    t9 = torch.where(torch.arange(K1_RAYS, device=dev) % 2 == 0, 1e4, -1.0)
    nested = nested_scene()
    k1_rows = {}
    for leaf in K1_LEAVES:
        sw_l = sw0 if leaf == sw0.leaf_size else refit_scene_wide(
            scene_bvh(scene, 0.0, dev, leaf), worlds_f)
        print(f"  K1 at L{leaf}: {sw_l.num_nodes} nodes, stack bound "
              f"{sw_l.k1_stack} of {K1_MAX_STACK}")
        rows = [k1_check("check rays", sw_l, o, d, t_max),
                k1_check("9-instance scene",
                         scene_bvh(nested, 1.3, dev, leaf), o9, d9, t9)]
        for label, (wo, wd, wt_min, wt_max) in zip(
                ("primary wave", "reflection wave"), waves):
            rows.append(k1_check(label, sw_l, wo, wd, wt_max, wt_min))
        k1_rows[leaf] = rows
    res = {"K1": dict(k1_rows[sw0.leaf_size][2], max_abs_err=max(
        r["max_abs_err"] for rows in k1_rows.values() for r in rows))}
    # K1's slim and fat modes at the renderer's leaf size; the JSON line
    # reports the full primary wave, the error of all
    mode_rows = {"K1s": [], "K1f": [], "K1e": []}
    for label, (wo, wd, wt_min, wt_max) in zip(
            ("check rays", "primary wave", "reflection wave"),
            [(o, d, 0.0, t_max)] + list(waves)):
        for k, row in k1_modes_check(label, sw0, wo, wd, wt_max,
                                     wt_min).items():
            mode_rows[k].append(row)
    for k, rows in mode_rows.items():
        res[k] = dict(rows[1], max_abs_err=max(r["max_abs_err"]
                                               for r in rows))

    # K4/K5: 8,192 primary and 8,192 reflection rays of the "wide" frame,
    # in the model instance's object space, at the reflection wave's
    # t_min.  The model covers a small part of the frame, so up to half of
    # each set are rays that K1 finds on the model, the rest are drawn
    # from the whole set; every other ray of each set is dead.
    n_prim, half = o_f.shape[0] // 2, K1_RAYS // 2
    inst_f = trace_scene_wide_fused(sw0, o_f, d_f, 0.0, t_f)[0].inst

    def draw(idx, k):
        return idx[torch.as_tensor(rng.choice(idx.numel(), k, replace=False),
                                   device=dev)]

    parts = []
    for lo in (0, n_prim):
        idx = torch.arange(lo, lo + n_prim, device=dev)
        on_model = inst_f[lo:lo + n_prim] == model
        k = min(int(on_model.sum()), half // 2)
        parts += [draw(idx[on_model], k), draw(idx[~on_model], half - k)]
        print(f"  {'reflection' if lo else 'primary'} set: {k} rays on the "
              f"model, {half - k} drawn from the rest")
    pick = torch.cat(parts)
    alive = torch.arange(K1_RAYS, device=dev) % 2 == 0
    o_m, d_m = o_f[pick].contiguous(), d_f[pick].contiguous()
    t_m = torch.where(alive, t_f[pick], -1.0).contiguous()
    inv_model = inv_rows(torch.linalg.inv(worlds_f))[model].contiguous()
    per_mesh_trees = {"K4": (flat, trace_tiles_flat),
                      "K5": (wide, trace_tiles4)}
    checks = {k: [per_mesh_check(f"{k} model mesh", tree, kernel, o_m, d_m,
                                 T_MIN_SECONDARY, t_m, inv_model)]
              for k, (tree, kernel) in per_mesh_trees.items()}
    # K4/K5 on the frame's two full waves, as the frame hands them over
    for label, (wo, wd, wt_min, wt_max) in zip(
            ("primary wave", "reflection wave"), waves):
        for k, row in per_mesh_wave_check(label, per_mesh_trees, wo, wd,
                                          wt_min, wt_max, inv_model).items():
            checks[k].append(row)
    worlds9 = nested.worlds(np.float32(1.3)).to(dev)
    for trav, key, scene_fn in (("pallas", "flat", trace_scene_flat),
                                ("pallas4", "wide", trace_scene4)):
        geom = upload_scene(nested, dev, traversal=trav, leaf_size=8)
        tlas = build_tlas(geom.bounds, worlds9, nested.mesh_ids)
        k = "K4" if trav == "pallas" else "K5"
        err = scene_loop_check(f"{k} 9-instance scene loop",
                               getattr(geom, key), scene_fn, tlas, o9, d9, t9)
        # the JSON line reports the full primary wave, the error of all
        res[k] = dict(checks[k][1], max_abs_err=max(
            err, *(r["max_abs_err"] for r in checks[k])))

    rm = Renderer(scene, device=dev)
    for mesh_idx in (0, 1):
        rm.set_metallic(mesh_idx, 0.5)
    _, _, aux = rm.step(rm.init_state())
    res.update(spatial_check(aux, W, H))
    del rm, aux
    res["XF"] = xform_check(rng, dev)
    res["TS"] = ts_check(rng, dev)
    res["BS"] = bs_check(renderer, dev)

    print("== phase 4: paths at 1280x720")
    runs = {"wide": drive_path(renderer, "wide", TIMED_FRAMES, METAL_FRAMES,
                               [2, 0, 0, 0, 2, 0, 0, 0, 4, 1, 1],
                               [3, 0, 0, 0, 2, 2, 0, 0, 4, 1, 2], card)}
    runs["pallas4"] = drive_path(per_mesh["pallas4"], "pallas4",
                                 PER_MESH_TIMED, PER_MESH_METAL,
                                 [0, 0, 0, 0, 2, 0, 0, 4, 5, 1, 0],
                                 [0, 0, 0, 0, 2, 2, 0, 6, 6, 1, 0], card)
    runs["pallas"] = drive_path(per_mesh["pallas"], "pallas",
                                PER_MESH_TIMED, PER_MESH_METAL,
                                [0, 0, 0, 0, 2, 0, 4, 0, 5, 1, 0],
                                [0, 0, 0, 0, 2, 2, 6, 0, 6, 1, 0], card)
    kernels_switch_check(scene, dev, card)
    knobs = knob_paths(scene, dev, card)
    fat_launches = fat_path_check(renderer, worlds_f, waves)

    print("== phase 5: golden cube scene")
    golden_check(dev)
    for trav in ("pallas4", "pallas"):
        golden_check(dev, trav)
        golden_check(dev, trav, ndc_fmt=True)

    print("== phase 6: kernel lab")
    lab_rows, lab_counts = kernel_lab(dev, rng, card)
    res.update(lab_rows)

    print("== phase 7: frame loop and CLI")
    timing = frame_loop(renderer, per_mesh, dev, card)

    print("== phase 8: the bench")
    benched = bench_check(dev, card)

    print("== phase 9: row bands")
    band_launches, band_ms = bands_check(scene, dev, card)

    # launches: each kernel's count over its own path's run (K1-K3: "wide")
    meta = [
        ("K1 trace_tiles_instanced", "csrc/traverse.cu",
         "raytracedggx_tpu/ops/fused.py:216", runs["wide"]["launches"][0]),
        ("K1s trace_tiles_instanced(slim=True)", "csrc/traverse.cu",
         "raytracedggx_tpu/ops/fused.py:216",
         knobs["trace_slim"]["launches"][1]),
        ("K1f trace_tiles_instanced(lean=False)", "csrc/traverse.cu",
         "raytracedggx_tpu/ops/fused.py:216", fat_launches),
        # K1s's epilogue: the reference recomputed u, v in XLA after its
        # slim kernel
        ("K1e slim_uv", "csrc/traverse.cu",
         "raytracedggx_tpu/ops/scene_wide.py:456",
         knobs["trace_slim"]["launches"][3]),
        ("K2 reflection_pass", "csrc/spatial.cu",
         "raytracedggx_tpu/ops/spatial_pallas.py:35",
         runs["wide"]["launches"][4]),
        ("K3 diffuse_pass", "csrc/spatial.cu",
         "raytracedggx_tpu/ops/spatial_pallas.py:77",
         runs["wide"]["launches"][5]),
        ("K4 trace_tiles_flat", "csrc/traverse_flat.cu",
         "raytracedggx_tpu/ops/traverse_pallas.py:40",
         runs["pallas"]["launches"][6]),
        ("K5 trace_tiles4", "csrc/traverse_wide4.cu",
         "raytracedggx_tpu/ops/wide.py:166", runs["pallas4"]["launches"][7]),
        ("K6a trace_tiles_lab", "csrc/traverse_lab.cu",
         "raytracedggx_tpu/ops/lab/fused_lab.py:73", lab_counts[0]),
        ("K6b trace_tiles_lab(leaf_stack=True)", "csrc/traverse_lab.cu",
         "raytracedggx_tpu/ops/lab/fused_lab.py:471", lab_counts[1]),
        ("K7 trace_tiles_mxu", "csrc/traverse_mxu.cu",
         "raytracedggx_tpu/ops/lab/fused_mxu.py:98", lab_counts[2]),
        # no Pallas kernel: the take_small one-hot matmuls and einsums
        ("XF instance_xform", "csrc/xform.cu",
         "raytracedggx_tpu/trace/raygen.py:313", runs["wide"]["launches"][8]),
        # no Pallas kernel: the JAX package leaves the TAA to XLA
        ("TS temporal_ss", "csrc/temporal.cu",
         "raytracedggx_tpu/denoise/temporal.py:148",
         runs["wide"]["launches"][9]),
        # no Pallas kernel: the JAX package leaves the shading to XLA
        ("BS shade_bounce", "csrc/shade.cu",
         "raytracedggx_tpu/trace/raygen.py:418",
         runs["wide"]["launches"][10]),
    ]
    # K1-K3 also launch on the bench's configs (phase 8, counted in the
    # bench's process) and on the bands (phase 9): "launches" is the sum
    # over the paths, "launches_by_path" each path's count
    by_path = {k: {"wide": n, **{f"bench config {i}": b[1][k]
                                 for i, b in benched.items()},
                   "bands": band_launches[k]}
               for k, n in (("K1", meta[0][3]), ("K2", meta[4][3]),
                            ("K3", meta[5][3]))}
    kernels = []
    for name, src, rep, n in meta:
        k = name.split()[0]
        paths = by_path.get(k)
        row = dict(name=name, route="cuda",
                   source=f"raytracedggx_tpu_torch/{src}", replaces=rep,
                   launches=sum(paths.values()) if paths else n,
                   **{"library_ms": None, **res[k]})
        if paths:
            row["launches_by_path"] = paths
        kernels.append(row)
    print(f"build {build_secs:.3f} s; "
          + "; ".join(f"{k} {v['ms']:.4f} ms/frame, metallic 0.5 "
                      f"{v['ms_metal']:.4f} ms/frame"
                      for k, v in runs.items())
          + "; knobs paired: " + "; ".join(
              f"{k} {v['ms']:.4f} ms/frame, metallic 0.5 "
              f"{v['ms_metal']:.4f}" for k, v in knobs.items())
          + "; frame loop: " + "; ".join(
              f"metallic {m:g} eager {np.mean(t['eager']['ms']):.4f}, "
              f"captured {np.mean(t['captured']['ms']):.4f} ms/frame"
              for m, t in timing.items())
          + "; bench: " + "; ".join(
              f"config {i} {rec['value']} Mrays/s"
              for i, (rec, _) in benched.items())
          + "; bands: " + ", ".join(f"{k} {v:.4f}" for k, v in band_ms.items())
          + f" ms/frame; {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
