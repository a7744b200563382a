"""The import rules: nothing the benchmark runs loads JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracedggx_tpu"}
PROGRAM = "raytracedggx_tpu_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): imported_tops(f) & FORBIDDEN for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    assert not [str(f) for f in files if PROGRAM in imported_tops(f)]
    for f in files:
        assert PROGRAM not in f.read_text()


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.delitem(sys.modules, "raytracedggx_tpu", raising=False)
    monkeypatch.setitem(sys.modules, "raytracedggx_tpu_torch.engine", None)
    assert "raytracedggx_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raytracedggx_tpu.scene", None)
    assert "raytracedggx_tpu" in run.forbidden_modules()


REHEARSAL = """
import json, sys, torch
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
import run, spec, calibrate
from conftest import shrink
cell = spec.find_cell("dragon-720p.anim-m05")
shrink(cell.config, 32, 18, 4)
out = run.run(cell, 7, 0.3, True, torch.device("cpu"), log=lambda s: None,
              trace_frames=4)
assert set(out) >= {{"correct", "checks"}}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_cpu_rehearsal_loads_no_forbidden_module():
    code = REHEARSAL.format(bench=str(BENCH), tests=str(BENCH / "tests"),
                            root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded and "reference" in loaded
    assert not loaded & FORBIDDEN
