"""The port and chip_smoke.py import nothing of JAX or the JAX package.

Every module of ``raytracedggx_tpu_torch`` (and ``chip_smoke``) is
imported in a fresh interpreter in which ``jax``, ``jaxlib`` and
``raytracedggx_tpu`` are blocked in ``sys.modules``: an import of any of
them, however indirect, raises there."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "raytracedggx_tpu"):
    sys.modules[name] = None          # any import of these now raises
import raytracedggx_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "raytracedggx_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 40     # every module was imported
