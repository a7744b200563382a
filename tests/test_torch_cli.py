"""The port's CLI and engine surface against the JAX package's: analogs
of tests/test_cli.py:7-152.  ``parse_args`` gives the reference's
namespace; the interactive hotkeys give the reference loop's materials,
toggles and stats flags; ``OrbitController`` the reference's camera;
and one end-to-end ``main()`` of each package on the same small OBJ
writes PNGs that agree within the frame bar of
tests/test_torch_renderer.py.  Everything runs on the CPU (``-warp``).
"""

import io
import json
import os
import re

import numpy as np
import pytest
import torch

from raytracedggx_tpu.engine import cli as j_cli
from raytracedggx_tpu.engine import RenderConfig as JRenderConfig
from raytracedggx_tpu.engine import Renderer as JRenderer
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.camera import Camera as JCamera
from raytracedggx_tpu.scene.camera import OrbitController as JOrbit
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube

from raytracedggx_tpu_torch.engine import RenderConfig, Renderer
from raytracedggx_tpu_torch.engine import cli
from raytracedggx_tpu_torch.scene import Scene, default_materials, ground_cube
from raytracedggx_tpu_torch.scene.camera import Camera, OrbitController
from raytracedggx_tpu_torch.scripts.standin import model_mesh, write_obj
from test_torch_renderer import POS, _frame_bar

ARGV = [
    ["-mesh", "m.obj", "0.0", "2.8", "0.0", "0.03"],
    ["-mesh", "Assets/bunny.obj", "0.0", "0.0", "0.0", "1.0"],
    ["-env", "Assets/galileo_cross.dds"],
    ["--no-spatial", "--no-temporal", "--pause", "--bary", "ndc",
     "--kernels", "pallas", "--metallic", "1", "0.5", "--screenshot", "8",
     "--extra-instance", "1", "2", "3", "0.5", "-warp"],
    ["--width", "320", "--height", "180", "--frames", "5", "--dt", "0.1",
     "--out", "x.png", "--no-async", "--emulate-formats", "--traversal",
     "pallas4", "--interactive", "--frames-per-cmd", "2", "--stats",
     "--profile", "logdir", "--log", "l.jsonl", "--stage-times"],
    [],
]
SCRIPT = ["pause", "right", "up", "down", "down", "a", "drag 64 -32",
          "wheel 1", "v", "shot", "run 2", "left", "up", "help", "bogus",
          "v", "quit"]


@pytest.mark.parametrize("argv", ARGV)
def test_parse_args_matches_reference(argv):
    assert vars(cli.parse_args(argv)) == vars(j_cli.parse_args(argv))


def test_help_and_defaults_match_reference():
    assert cli.INTERACTIVE_HELP == j_cli.INTERACTIVE_HELP
    assert cli.DEFAULT_MESH == j_cli.DEFAULT_MESH
    assert cli.DEFAULT_ENV == j_cli.DEFAULT_ENV
    assert cli.KERNELS["pallas"] == "cuda"


def _flags(out):
    """The stats lines' toggle flags, without the fps."""
    return [re.sub(r"^.*?fps ", "", line) for line in out.splitlines()
            if " fps " in line]


def _reference_renderer():
    """The reference Renderer's state that its interactive loop and its
    set_metallic / set_kernels / set_async_compute read, as its
    constructor leaves it on the CPU ("auto" filters are "xla"), without
    the scene upload and BVH builds; its step returns black frames (the
    frame tests hold the reference's frames)."""
    import jax.numpy as jnp
    from raytracedggx_tpu.trace.raygen import MaterialsDev

    jr = JRenderer.__new__(JRenderer)
    jr.config = JRenderConfig(width=48, height=32)
    jr.scene = JScene(meshes=[j_ground_cube(), j_ground_cube()],
                      materials=j_materials(), pos_scale=POS)
    jr.camera = JCamera(width=48, height=32)
    mats = jr.scene.instance_materials()
    jr.materials = MaterialsDev(base_colors=jnp.asarray(mats.base_colors),
                                rough_metals=jnp.asarray(mats.rough_metals))
    jr.kernels, jr.kernels_interpret = "xla", False
    jr.step = lambda state, dt=0.0, cam=None: (
        state, jnp.zeros((32, 48, 3), jnp.float32), {})
    jr.init_state = lambda: None
    return jr


def test_interactive_hotkeys_match_reference(tmp_path, capsys):
    """The same command script through both loops: the same metallics,
    async and kernel toggles and stats flags, and a screenshot."""
    jr = _reference_renderer()
    tr = Renderer(Scene(meshes=[ground_cube(), ground_cube()],
                        materials=default_materials(), pos_scale=POS),
                  config=RenderConfig(width=48, height=32), device="cpu")
    out = {}
    for name, mod, r in (("ref", j_cli, jr), ("port", cli, tr)):
        png = tmp_path / f"{name}.png"
        args = mod.parse_args(["--out", str(png), "--frames-per-cmd", "1"])
        stream = io.StringIO("\n".join(SCRIPT) + "\n")
        _, frame = mod.interactive_loop(r, r.init_state(), args, r.scene,
                                        "ground", stream=stream)
        assert frame is not None
        assert (tmp_path / f"{name}_shot001.png").exists()
        out[name] = capsys.readouterr().out
    assert _flags(out["port"]) == _flags(out["ref"])
    assert len(_flags(out["port"])) == 15
    assert "[V]on" in out["port"] and "[A]off" in out["port"]
    np.testing.assert_array_equal(tr.materials.rough_metals.numpy(),
                                  np.asarray(jr.materials.rough_metals))
    assert tr.config.async_compute == jr.config.async_compute
    assert cli.INTERACTIVE_HELP in out["port"]
    assert "? unknown command: bogus" in out["port"]
    # V back off: the plain passes; on the CPU "auto" stands for on
    assert tr.kernels == "xla" and jr.kernels == "xla"


def test_orbit_controller_matches_reference():
    """Drags and wheel notches move the port's orbit camera as the
    reference's (RayTracedGGX.cpp:401-455), and the reference's checks
    hold: a drag keeps the orbit radius, a full-width drag returns, a
    wheel notch moves the eye by len/16."""
    port = OrbitController(Camera(width=1280, height=720))
    ref = JOrbit(JCamera(width=1280, height=720))
    r0 = np.linalg.norm(port.focus - port.eye)
    for op, a in (("drag", (320.0, -90.0)), ("wheel", (1.0,)),
                  ("drag", (-40.0, 25.0)), ("wheel", (-2.5,))):
        getattr(port, op)(*a)
        getattr(ref, op)(*a)
        np.testing.assert_allclose(port.view, np.asarray(ref.view),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port.eye, np.asarray(ref.eye),
                                   rtol=1e-5, atol=1e-5)
        for got, want in zip(port.arrays(), ref.arrays()):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
        if op == "drag":
            assert np.isclose(np.linalg.norm(port.focus - port.eye), r0,
                              rtol=1e-4)
        else:
            r0 = np.linalg.norm(port.focus - port.eye)
    full = OrbitController(Camera(width=1280, height=720))
    eye0 = full.eye.copy()
    full.drag(1280.0, 0.0)
    np.testing.assert_allclose(full.eye, eye0, atol=1e-3)
    dolly = OrbitController(Camera(width=1280, height=720))
    r1 = np.linalg.norm(dolly.focus - dolly.eye)
    dolly.wheel(1.0)
    assert np.isclose(np.linalg.norm(dolly.focus - dolly.eye),
                      r1 * (1 - 1 / 16), rtol=1e-4)


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Both packages' main() on one small OBJ (the stand-in model at one
    subdivision), with the reference's compile cache under tmp."""
    tmp = tmp_path_factory.mktemp("cli")
    obj = str(tmp / "model.obj")
    write_obj(obj, model_mesh(1))
    argv = ["-mesh", obj, "0", "2", "0", "1", "-warp", "--traversal", "jax",
            "--width", "32", "--height", "18", "--frames", "2"]
    out = {}
    import jax

    cache = jax.config.jax_compilation_cache_dir
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RTGGX_CACHE_DIR", str(tmp / "cache"))
            for name, mod in (("ref", j_cli), ("port", cli)):
                png = str(tmp / f"{name}.png")
                mod.main(argv + ["--out", png])
                out[name] = _read_png(png)
    finally:          # the reference's main() moved the process's cache
        jax.config.update("jax_compilation_cache_dir", cache)
    return dict(tmp=tmp, obj=obj, argv=argv, **out)


def test_main_end_to_end_matches_reference(mains):
    assert mains["port"].shape == mains["ref"].shape == (18, 32, 3)
    assert float(mains["port"].std()) > 1e-3
    _frame_bar(mains["port"], mains["ref"])


def test_main_outputs(mains, monkeypatch, capsys):
    """--stage-times, --log, --screenshot, --stats and --profile on the
    CPU: a line per stage of the frame, read from its stage marks, one
    log line per frame, a PNG per screenshot, a Chrome trace; then
    --interactive over stdin."""
    tmp = mains["tmp"]
    png = str(tmp / "outputs.png")
    cli.main(mains["argv"] + [
        "--out", png, "--stage-times", "--log", str(tmp / "log.jsonl"),
        "--screenshot", "1", "--stats", "--profile", str(tmp / "trace")])
    text = capsys.readouterr().out
    for stage in ("refit", "primary", "reflection", "spatial", "taa",
                  "tonemap"):
        assert re.search(rf"^{stage}_ms: \d+\.\d{{3}}$", text, re.M), text
    lines = (tmp / "log.jsonl").read_text().splitlines()
    assert [json.loads(x)["frame"] for x in lines] == [0, 1]
    assert all(os.path.exists(str(tmp / f"outputs_{i:04d}.png"))
               for i in (1, 2))
    assert os.path.getsize(str(tmp / "trace" / "trace.json")) > 0
    np.testing.assert_array_equal(_read_png(png), mains["port"])

    monkeypatch.setattr("sys.stdin", io.StringIO("up\nrun 1\nquit\n"))
    cli.main(mains["argv"] + ["--out", png, "--interactive",
                              "--frames-per-cmd", "1"])
    text = capsys.readouterr().out
    assert "wrote" in text and "interactive session" in text
    assert len(_flags(text)) == 3


@pytest.mark.parametrize("metallic", [None, 0.5])
def test_stage_times_print_each_stage_from_the_marks(mains, capsys,
                                                     metallic):
    """--stage-times alone prints one line per stage that the frames ran,
    in the frame's order (the diffuse wave's only where its gate is
    open), timed from the marks' host events on the CPU; without
    --profile it names no trace."""
    extra = ["--metallic", "1", str(metallic)] if metallic else []
    cli.main(mains["argv"] + extra + [
        "--out", str(mains["tmp"] / "stages.png"), "--stage-times"])
    text = capsys.readouterr().out
    assert "host clock" in text and "profiler trace" not in text
    got = re.findall(r"^(\w+)_ms: (\d+\.\d{3})$", text, re.M)
    want = ["refit", "primary", "reflection", "diffuse", "spatial", "taa",
            "tonemap"]
    if metallic is None:
        want.remove("diffuse")
    assert [name for name, _ in got] == want
    assert all(float(ms) >= 0.0 for _, ms in got)


def test_main_needs_a_card_without_warp(mains):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main renders on it")
    argv = [a for a in mains["argv"] if a != "-warp"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--out", str(mains["tmp"] / "none.png")])


def test_missing_mesh_raises_as_in_reference(tmp_path):
    missing = str(tmp_path / "missing.obj")
    with pytest.raises(FileNotFoundError):
        cli.main(["-mesh", missing, "-warp", "--frames", "1"])
