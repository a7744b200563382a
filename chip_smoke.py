#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's default frame path once on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure ends the run non-zero):
 0. the machine: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
 1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and load them;
 2. the scene: ground cube + a deterministic ~82k-triangle displaced
    icosphere standing in for the bunny, and its instanced scene BVH (L=64);
 3. each kernel against its plain torch version on the card, at the shapes
    the frame gives it (K1 on 16,384 rays, K2/K3 on 1280x720 G-buffers);
 4. the main path: Renderer(device="cuda") at 1280x720, 3 warm-up then 60
    timed frames with launch counts, then 10 frames at metallic 0.5 (the
    diffuse wave and filter live);
 5. the golden cube scene at 96x54, 3 frames, against the JAX package's
    frozen PNG.
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Needs CUDA: without it this exits non-zero
and prints no result.  Imports nothing of JAX or the JAX package.
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
W, H = 1280, 720
TIMED_FRAMES = 60
METAL_FRAMES = 10
K1_RAYS = 16384


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas", line.strip())
    return secs


# ---------------------------------------------------------------- phase 2
def model_mesh(subdiv: int = 6):
    """Icosphere subdivided ``subdiv`` times (20 * 4**subdiv triangles),
    radially displaced by a fixed smooth function of direction, with
    area-weighted smooth vertex normals."""
    from raytracedggx_tpu_torch.scene import Mesh

    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = inv.reshape(3, -1) + len(v)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[0], m[1], m[2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                            np.stack([ca, bc, c], 1),
                            np.stack([ab, bc, ca], 1)])
        v = np.concatenate([v, mid])
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    r = 1.0 + 0.12 * np.sin(4.0 * x + 1.0) * np.cos(3.0 * y) \
        + 0.08 * np.sin(6.0 * z + 2.0 * x)
    pos = v * r[:, None]
    fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, f[:, k], fn)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return Mesh(pos.astype(np.float32), nrm.astype(np.float32),
                f.reshape(-1).astype(np.uint32))


def model_scene():
    from raytracedggx_tpu_torch.scene import Scene, default_materials, \
        ground_cube

    return Scene(meshes=[ground_cube(), model_mesh()],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 1.0, 0.0, 1.0], np.float32))


def nested_scene():
    """The 9-instance scene of tests/test_scene_wide.py (nested top tree)."""
    from raytracedggx_tpu_torch.scene import Scene, default_materials, \
        ground_cube

    extra = tuple((2.5 * i - 5.0, 1.0, 2.5 * ((i * 7) % 3), 0.4)
                  for i in range(7))
    return Scene(meshes=[ground_cube(), ground_cube()],
                 materials=default_materials(),
                 pos_scale=np.array([0.0, 2.0, 0.0, 1.0], np.float32),
                 extra_instances=extra)


def scene_bvh(scene, angle, device, leaf_size=64):
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


def frame_rays(renderer):
    """Primary and reflection rays of the renderer's first frame and the
    BVH refit for it: (sw, o (2R, 3), d (2R, 3), t_max (2R,))."""
    from raytracedggx_tpu_torch.ops.scene_wide import (refit_scene_wide,
                                                       trace_scene_wide_fused)
    from raytracedggx_tpu_torch.trace import raygen

    cfg = renderer.config
    state = renderer.init_state()
    consts = renderer._constants(state, state.angle)
    sw = refit_scene_wide(renderer.swide, consts.worlds)

    def trace(o, d, t_min, t_max):
        return trace_scene_wide_fused(sw, o, d, t_min, t_max)

    _, p_near, ray_d = raygen.primary_rays(consts, cfg.width, cfg.height)
    surf = raygen.primary_surface(consts, renderer.materials, cfg.width,
                                  cfg.height, trace, renderer.ray_order)
    xi = raygen.pixel_samples(cfg.width, cfg.height, consts.frame_index,
                              p_near.device)
    _, _, r_dir, tmax_r = raygen.reflection_rays(surf, xi)
    t_prim = torch.full_like(tmax_r, raygen.T_MAX)
    return (sw, torch.cat([p_near, surf["p"]]), torch.cat([ray_d, r_dir]),
            torch.cat([t_prim, tmax_r]))


def k1_check(name, sw, o, d, t_max, t_min=0.0):
    """K1 against its plain version on the same rays; returns
    (max |dt| over hits, kernel ms, plain ms)."""
    from raytracedggx_tpu_torch.ops.fused import (trace_instanced_plain,
                                                  trace_tiles_instanced)

    def kern():
        return trace_tiles_instanced(sw.nodes, sw.tris, sw.inv_mats,
                                     sw.inst_slots, o, d, t_min, t_max,
                                     sw.leaf_size, sw.stack)

    def plain():
        return trace_instanced_plain(sw.tris, sw.inv_mats, sw.inst_slots, o,
                                     d, t_min, t_max)

    got, ref = kern(), plain()
    if o.is_cuda:
        torch.cuda.synchronize()
    g_hit, r_hit = got[3] >= 0, ref[3] >= 0
    n_diff = int((g_hit != r_hit).sum())
    check(n_diff == 0, f"K1 {name}: hit mask exact "
          f"({int(r_hit.sum())} hits of {o.shape[0]} rays, {n_diff} differ)")
    h = r_hit
    err = (got[0][h] - ref[0][h]).abs()
    tol = 1e-5 + 1e-4 * ref[0][h].abs()
    check(bool((err <= tol).all()), f"K1 {name}: t at rtol 1e-4 atol 1e-5 "
          f"(max |dt| {float(err.max()) if err.numel() else 0.0:.3e})")
    same = ((got[3] == ref[3]) & (got[4] == ref[4]))[h].float().mean()
    check(float(same) >= 0.99, f"K1 {name}: (inst, slot) agree on "
          f"{float(same):.5f} of hits")
    dead = t_max < 0
    check(not bool((g_hit & dead).any()), f"K1 {name}: all "
          f"{int(dead.sum())} rays with t_max < 0 miss")
    ms = plain_ms = None
    if o.is_cuda:
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        print(f"  K1 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return float(err.max()) if err.numel() else 0.0, ms, plain_ms


def spatial_check(aux_out, width, height):
    """K2 and K3 against their plain versions on a frame's G-buffers,
    both axes; returns {name: (max_abs_err, ms, plain_ms)}."""
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
    cases = {
        "K2": (tm(aux_out["refl"]).contiguous(), hit,
               lambda s, ax: reflection_pass(s, normal, rough, depth, width,
                                             height, ax),
               lambda s, ax: reflection_pass_plain(s, normal, rough, depth,
                                                   width, height, ax)),
        "K3": (tm(aux_out["diff"]).contiguous(), gate,
               lambda s, ax: diffuse_pass(s, normal, metal, depth, ax),
               lambda s, ax: diffuse_pass_plain(s, normal, metal, depth, ax)),
    }
    for name, (src, mask, kern, plain) in cases.items():
        h_ref = plain(src, 1)
        h_src = torch.where(mask, h_ref, 0.0).contiguous()
        errs = []
        for ax, s in ((1, src), (0, h_src)):
            got, ref = kern(s, ax), plain(s, ax)
            err = (got - ref).abs()
            ok = bool((err <= 2e-5 + 1e-4 * ref.abs()).all())
            errs.append(float(err.max()))
            check(ok, f"{name} axis {ax}: atol 2e-5 rtol 1e-4 (max err "
                  f"{errs[-1]:.3e})")
        ms = plain_ms = None
        if src.is_cuda:
            ms = cuda_ms(lambda: kern(src, 1), 20)
            plain_ms = cuda_ms(lambda: plain(src, 1), 5)
            print(f"  {name} one pass: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
        res[name] = (max(errs), ms, plain_ms)
    return res


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


def golden_check(device):
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.scene import Scene, default_materials, \
        ground_cube

    scene = Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(),
                  pos_scale=np.array([0, 3.0, 0, 1.0], np.float32))
    r = Renderer(scene, config=RenderConfig(width=96, height=54),
                 device=device)
    state, frame = r.run_frames(3)
    got = frame.clamp(0, 1).cpu().numpy()
    diff = np.abs(got - read_png(GOLDEN))
    mean = float(diff.mean())
    frac = float((diff.max(axis=-1) > 0.05).mean())
    print(f"  golden 96x54 f3: mean {mean:.6f}, max {float(diff.max()):.6f},"
          f" pixels > 0.05: {frac:.6f}")
    check(mean < 3e-3, "golden mean diff < 3e-3")
    check(frac < 2e-3, "golden: fewer than 0.2% of pixels off by > 0.05")
    check(state.history.dtype == torch.float16, "TAA history stays f16")


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
    from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
    from raytracedggx_tpu_torch.ops.fused import trace_tiles_instanced
    from raytracedggx_tpu_torch.ops.spatial_cuda import (diffuse_pass,
                                                         reflection_pass)

    t0 = time.perf_counter()
    scene = model_scene()
    renderer = Renderer(scene, device=dev)
    sw = renderer.swide
    n_tris = sum(m.num_triangles for m in scene.meshes)
    print(f"  triangles {n_tris}, stream slots {sw.tris.shape[0]}, leaves "
          f"{sw.tris.shape[0] // sw.leaf_size}, nodes {sw.num_nodes}, "
          f"stack {sw.stack}, L {sw.leaf_size}; renderer set-up "
          f"{time.perf_counter() - t0:.3f} s")

    print("== phase 3: kernels against their plain versions")
    rng = np.random.default_rng(1234)
    n3 = K1_RAYS // 4
    o_r, d_r = rand_rays(rng, n3, dev)
    t_r = torch.where(torch.arange(n3, device=dev) % 2 == 0, 1e4, -1.0)
    sw0, o_f, d_f, t_f = frame_rays(renderer)
    pick = torch.as_tensor(rng.choice(o_f.shape[0], K1_RAYS - n3,
                                      replace=False), device=dev)
    o = torch.cat([o_r, o_f[pick]]).contiguous()
    d = torch.cat([d_r, d_f[pick]]).contiguous()
    t_max = torch.cat([t_r, t_f[pick]]).contiguous()
    k1_err, k1_ms, k1_plain_ms = k1_check("model scene", sw0, o, d, t_max)
    o9, d9 = rand_rays(rng, K1_RAYS, dev)
    t9 = torch.where(torch.arange(K1_RAYS, device=dev) % 2 == 0, 1e4, -1.0)
    k1_check("9-instance scene", scene_bvh(nested_scene(), 1.3, dev), o9, d9,
             t9)

    rm = Renderer(scene, device=dev)
    for mesh_idx in (0, 1):
        rm.set_metallic(mesh_idx, 0.5)
    _, _, aux = rm.step(rm.init_state())
    spatial = spatial_check(aux, W, H)
    del rm, aux

    print("== phase 4: main path, 1280x720")
    state = renderer.init_state()
    for _ in range(3):
        state, frame, aux = renderer.step(state)
    hit = aux["normal"][..., 3] > 0.5
    metal = aux["rough_metal"][..., 1]
    rays = W * H + int(hit.sum()) + int((hit & (metal < 1.0)).sum())
    torch.cuda.synchronize()
    counters = (trace_tiles_instanced, reflection_pass, diffuse_pass)
    for fn in counters:
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_FRAMES):
        state, frame, _ = renderer.step(state)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TIMED_FRAMES
    counts = [fn.launches for fn in counters]
    print(f"  {ms:.4f} ms/frame, {rays} live rays/frame, "
          f"{rays / ms / 1e3:.4f} Mrays/s over {TIMED_FRAMES} frames "
          f"({card})")
    f = frame.float()
    check(bool(torch.isfinite(f).all()) and float(f.std()) > 1e-3,
          f"frame finite and not constant (std {float(f.std()):.4f})")
    check(counts == [2 * TIMED_FRAMES, 2 * TIMED_FRAMES, 0],
          f"launches K1/K2/K3 {counts} = 2/2/0 per frame")

    for mesh_idx in (0, 1):
        renderer.set_metallic(mesh_idx, 0.5)
    start.record()
    for _ in range(METAL_FRAMES):
        state, frame, _ = renderer.step(state)
    end.record()
    end.synchronize()
    ms_metal = start.elapsed_time(end) / METAL_FRAMES
    total = [fn.launches for fn in counters]
    delta = [a - b for a, b in zip(total, counts)]
    print(f"  metallic 0.5: {ms_metal:.4f} ms/frame over {METAL_FRAMES} "
          f"frames ({card})")
    check(bool(torch.isfinite(frame).all()), "metallic 0.5 frame finite")
    check(delta == [3 * METAL_FRAMES, 2 * METAL_FRAMES, 2 * METAL_FRAMES],
          f"launches K1/K2/K3 {delta} = 3/2/2 per frame at metallic 0.5")

    print("== phase 5: golden cube scene")
    golden_check(dev)

    kernels = [
        dict(name="K1 trace_tiles_instanced", route="cuda",
             source="raytracedggx_tpu_torch/csrc/traverse.cu",
             replaces="raytracedggx_tpu/ops/fused.py:216",
             launches=total[0], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms),
        dict(name="K2 reflection_pass", route="cuda",
             source="raytracedggx_tpu_torch/csrc/spatial.cu",
             replaces="raytracedggx_tpu/ops/spatial_pallas.py:35",
             launches=total[1], max_abs_err=spatial["K2"][0],
             ms=spatial["K2"][1], plain_ms=spatial["K2"][2]),
        dict(name="K3 diffuse_pass", route="cuda",
             source="raytracedggx_tpu_torch/csrc/spatial.cu",
             replaces="raytracedggx_tpu/ops/spatial_pallas.py:77",
             launches=total[2], max_abs_err=spatial["K3"][0],
             ms=spatial["K3"][1], plain_ms=spatial["K3"][2]),
    ]
    print(f"build {build_secs:.3f} s; main path {ms:.4f} ms/frame; "
          f"metallic 0.5 {ms_metal:.4f} ms/frame; {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
