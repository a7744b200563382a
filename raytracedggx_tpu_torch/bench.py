"""Benchmark of the port: end-to-end frame rate of the default frame on
one NVIDIA GPU, with the contract of the JAX package's root ``bench.py``.

    python -m raytracedggx_tpu_torch.bench [--all-configs]

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N,
   "note": ...}

Workload: the model scene, 1 spp (primary + GGX reflection + diffuse),
full spatial + temporal denoise + tone map, animated model (TLAS and
scene BVH refit per frame).  ``vs_baseline`` is Mrays/s over the north
star, 60 frames/s at 1080p with 3 rays a pixel = 1920*1080*3*60 = 373.2
Mrays/s.  Only *live* rays count: primary (W*H) + reflection (one per
primary hit) + diffuse (one per primary hit with metallic < 1), counted
from the warm-up frame's G-buffers.  The clock runs over ``step_n``
chunks of min(30, frames) frames (one captured CUDA graph replayed per
frame) after one chunk that captures it, and stops after a device sync
and a host read of the last frame.

The measurement runs in a CHILD process under its own watchdog; the
parent never imports torch and always prints exactly one JSON line per
config: the child's on success, a value=0 sentinel with a note on a
crash, a non-zero exit or a timeout.

The child renders on the CUDA device.  ``RTGGX_BENCH_DEVICE`` (the
counterpart of the reference's ``RTGGX_BENCH_PLATFORM``) names another
torch device, e.g. ``cpu`` for a rehearsal at a small
``RTGGX_BENCH_RES``; with no CUDA device and no such variable the child
raises, and the parent prints the sentinel.  It never falls back to the
CPU.

The reference's assets (``bunny.obj``, ``dragon.obj``, the DDS probes)
go in ``reference/Bin/Assets`` inside the checkout (the reference
application's ``Bin/Assets``); nothing outside the checkout is read.
Where they are absent the model is the procedural stand-in
(``scripts/standin.model_mesh``: 81,920 triangles; 327,680 for config
2's dragon), written to an OBJ in a temporary directory and loaded
through ``Scene.create`` as a user's OBJ would be, and every probe is the
procedural sky.  Each note names the scene, the sky, the kernel launches
of the run, the peak device memory and the card with its power limit.

Env knobs (the reference's): RTGGX_BENCH_RES (default 1280x720, config
0), RTGGX_BENCH_FRAMES, RTGGX_BENCH_TIMEOUT (s), RTGGX_BENCH_TRAVERSAL,
RTGGX_BENCH_CONFIG (0-6, ``CONFIGS``); and RTGGX_BENCH_DEVICE.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

NORTH_STAR_MRAYS = 1920 * 1080 * 3 * 60 / 1e6  # 373.2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference application's assets, inside the checkout
ASSETS = os.path.join(ROOT, "reference", "Bin", "Assets")
# the stand-in model's placement: on the ground slab (scripts/standin.py)
STANDIN_POS = (0.0, 1.0, 0.0, 1.0)


def _res():
    res = os.environ.get("RTGGX_BENCH_RES", "1280x720")
    w, h = (int(v) for v in res.split("x"))
    return w, h


def _sentinel(note):
    w, h = _res()
    return {"metric": f"mrays_per_s_per_chip_e2e_{w}x{h}", "value": 0.0,
            "unit": "Mrays/s", "vs_baseline": 0.0, "note": note[:400]}


# the reference's configs (bench.py:50-78; config 0 = the headline
# workload); standin: the subdivision of the stand-in model without the
# asset
CONFIGS = {
    0: dict(name="headline_bunny_full", mesh="bunny.obj", envs=["rnl"],
            res=None, spatial=True, temporal=True, extra=0, animate=True,
            standin=6),
    1: dict(name="bunny_static_temporal_720p", mesh="bunny.obj",
            envs=["rnl"], res=(1280, 720), spatial=False, temporal=True,
            extra=0, animate=False, standin=6),
    2: dict(name="dragon_animated_refit", mesh="dragon.obj", envs=["rnl"],
            res=(1280, 720), spatial=True, temporal=True, extra=0,
            animate=True, standin=7),
    3: dict(name="full_denoise_both_variants_1080p", mesh="bunny.obj",
            envs=["rnl"], res=(1920, 1080), spatial=True, temporal=True,
            extra=0, animate=True, both_kernel_variants=True, standin=6),
    4: dict(name="env_sweep_tonemap", mesh="bunny.obj",
            envs=["galileo", "grace", "stpeters", "uffizi", "rnl"],
            res=(1280, 720), spatial=True, temporal=True, extra=0,
            animate=True, standin=6),
    # the name is the reference's: its bench never sets async_compute, and
    # step_n ignores it in both packages
    5: dict(name="4k_multi_instance_async_refit", mesh="bunny.obj",
            envs=["rnl"], res=(3840, 2160), spatial=True, temporal=True,
            extra=6, animate=True, frames=4, standin=6),
    # the three-wave frame: metallic 0.5 on both meshes arms the diffuse
    # wave, so this config is the only one whose cost includes it
    6: dict(name="three_wave_metallic05", mesh="bunny.obj", envs=["rnl"],
            res=(1280, 720), spatial=True, temporal=True, extra=0,
            animate=True, metallic=0.5, standin=6),
}
# the kernels the note counts: K1 (traversal "wide"), K2, K3 (filters),
# K4 / K5 ("pallas" / "pallas4")
NOTE_KERNELS = ("K1", "K2", "K3", "K4", "K5")


def card():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed ({e.__class__.__name__})"
    return out[0].strip() if out else "nvidia-smi printed nothing"


def _device():
    import torch

    name = os.environ.get("RTGGX_BENCH_DEVICE")
    if name:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (set RTGGX_BENCH_DEVICE=cpu for "
                           "a rehearsal on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def bench_scene(c, model_path, tmp):
    """(Scene, its name for the note): the reference's asset where
    present, else ``model_path`` or the stand-in written to an OBJ."""
    from .scene import Scene
    from .scripts.standin import model_mesh, write_obj

    extra = tuple((2.5 * (i % 3) - 2.5, 0.0, 2.5 * (i // 3) - 2.5, 0.6)
                  for i in range(1, c["extra"] + 1))
    asset = os.path.join(ASSETS, c["mesh"])
    if model_path is None and os.path.exists(asset):
        return Scene.create(asset, extra_instances=extra), c["mesh"]
    if model_path is None:
        model_path = os.path.join(tmp, f"standin{c['standin']}.obj")
        write_obj(model_path, model_mesh(c["standin"]))
    scene = Scene.create(model_path, pos_scale=STANDIN_POS,
                         extra_instances=extra)
    tris = scene.meshes[1].num_triangles
    return scene, (f"{os.path.basename(model_path)} ({tris} triangles, "
                   f"stand-in for {c['mesh']}) x{1 + c['extra']}")


def live_rays(aux, width, height):
    """(total, reflection, diffuse) live rays of a frame from its aux
    (``Renderer.step``'s G-buffers, (H, W, C))."""
    hit = aux["normal"][..., 3] > 0.5
    metal = aux["rough_metal"][..., 1]
    refl = int(hit.sum())
    diff = int((hit & (metal < 1.0)).sum())
    return width * height + refl + diff, refl, diff


def _run_config(cfg_id: int, model_path=None):
    """Measure one config; returns the JSON record.  model_path: an OBJ
    to load in place of the asset or the stand-in."""
    import torch

    from .engine import RenderConfig, Renderer
    from .engine.renderer import launch_counters, launch_counts
    from .io.dds import load_cubemap_env

    c = CONFIGS[cfg_id]
    w, h = c["res"] or _res()
    frames = int(os.environ.get("RTGGX_BENCH_FRAMES",
                                c.get("frames", 240)))
    dev = _device()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="rtggx-bench-") as tmp:
        scene, scene_name = bench_scene(c, model_path, tmp)
    envs, env_names = [], []
    for name in c["envs"]:
        path = os.path.join(ASSETS, f"{name}_cross.dds")
        if os.path.exists(path):
            envs.append(load_cubemap_env(path, dev))
            env_names.append(name)
        else:
            envs.append(None)
            env_names.append(f"{name}: procedural sky")

    variants = ["auto"]
    if c.get("both_kernel_variants"):   # the reference's "xla", "pallas"
        variants = ["xla", "cuda"]

    for _, fn, attr in launch_counters():
        setattr(fn, attr, 0)
    dt_total, notes, rays, captured = 0.0, [], None, None
    for kernels in variants:
        for env, env_name in zip(envs, env_names):
            cfg = RenderConfig(
                width=w, height=h, spatial=c["spatial"],
                temporal=c["temporal"], kernels=kernels,
                traversal=os.environ.get("RTGGX_BENCH_TRAVERSAL", "auto"))
            r = Renderer(scene, env=env, config=cfg, device=dev)
            if c.get("metallic") is not None:
                for mesh_idx in (0, 1):
                    r.set_metallic(mesh_idx, c["metallic"])
            state = r.init_state()
            anim_dt = 1 / 60 if c["animate"] else 0.0

            # warm-up; also measures the live-ray mix
            state, frame, aux = r.step(state, dt=anim_dt)
            rays = live_rays(aux, w, h)
            del aux

            # step_n chunks: one captured frame replayed per frame, the
            # deployment shape of a continuous render loop
            chunk = min(30, frames)
            state, frame = r.step_n(state, chunk, dt=anim_dt)  # capture
            frame.cpu()
            sync()
            t0 = time.perf_counter()
            done = 0
            while done < frames:
                state, frame = r.step_n(state, chunk, dt=anim_dt)
                done += chunk
            sync()
            frame.cpu()           # the last frame, read on the host
            dt = (time.perf_counter() - t0) / done
            dt_total += dt
            tag = kernels if len(variants) > 1 else env_name
            notes.append(f"{tag} {dt * 1e3:.4f} ms")
            captured = r.capture_launches
            del r, state, frame

    counts = launch_counts()
    dt_mean = dt_total / (len(variants) * len(envs))
    mrays = rays[0] / dt_mean / 1e6
    launches = " ".join(f"{k} {counts[k]}" for k in NOTE_KERNELS)
    if captured is not None:
        launches += " (captured frame: " + " ".join(
            f"{k} {captured[k]}" for k in NOTE_KERNELS) + ")"
    where = (f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}"
             f" GiB; {card()}" if cuda else f"device {dev}")
    return {
        "metric": f"mrays_per_s_per_chip_e2e_{w}x{h}"
                  + (f"_cfg{cfg_id}" if cfg_id else ""),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / NORTH_STAR_MRAYS, 5),
        "note": (f"{c['name']}: {dt_mean * 1e3:.4f} ms/frame "
                 f"({', '.join(notes)}); live rays/frame {rays[0]} "
                 f"(reflection {rays[1]}, diffuse {rays[2]}); {frames} "
                 f"frames; scene {scene_name}; launches {launches}; "
                 f"{where}"),
    }


def child():
    if "--all-configs" in sys.argv:
        for cfg_id in (1, 2, 3, 4, 5, 6):
            print(json.dumps(_run_config(cfg_id)), flush=True)
        return
    print(json.dumps(_run_config(
        int(os.environ.get("RTGGX_BENCH_CONFIG", "0")))), flush=True)


def _metric_lines(stdout):
    """The JSON lines with a "metric" key in a child's output."""
    out = []
    for line in (stdout or "").strip().splitlines():
        try:
            if "metric" in json.loads(line):
                out.append(line)
        except (json.JSONDecodeError, ValueError, TypeError):
            continue
    return out


def main():
    if "--child" in sys.argv:
        # a watchdog inside the child as well: a stall mid-measure still
        # lets the parent's timeout fire, but this exits sooner
        import signal

        def _timeout(signum, frame):
            sys.stderr.write("child watchdog expired\n")
            os._exit(3)

        signal.signal(signal.SIGALRM, _timeout)
        signal.alarm(max(10, int(os.environ.get("RTGGX_BENCH_TIMEOUT",
                                                "2400")) - 15))
        child()
        return

    timeout = int(os.environ.get("RTGGX_BENCH_TIMEOUT", "2400"))
    all_cfgs = "--all-configs" in sys.argv
    try:
        p = subprocess.run(
            [sys.executable, "-m", "raytracedggx_tpu_torch.bench", "--child"]
            + (["--all-configs"] if all_cfgs else []),
            cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        lines = _metric_lines(p.stdout)
        if all_cfgs:            # one line per config, as measured
            for line in lines:
                print(line)
        elif lines and p.returncode == 0:
            print(lines[-1])
        if p.returncode != 0 or not lines:
            err_tail = (p.stderr or "").strip().splitlines()[-3:]
            print(json.dumps(_sentinel(
                f"bench child rc={p.returncode}: " + " | ".join(err_tail))))
    except subprocess.TimeoutExpired:
        print(json.dumps(_sentinel(f"bench child timeout after {timeout}s")))
    except Exception as e:  # noqa: BLE001 — the JSON line must survive
        print(json.dumps(_sentinel(f"bench harness error: {e!r}")))


if __name__ == "__main__":
    main()
