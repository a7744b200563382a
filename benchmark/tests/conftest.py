"""The benchmark's CPU tests: the harness's modules import as run.py
imports them (``benchmark/`` first on the path), the port from the
checkout's root.  Nothing here imports JAX."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU's stand-in for a cell: the same frame at a size a test holds,
# the model at about 1,300 triangles on either tessellation
TINY_LEVEL = {"midpoint": 3, "geodesic": 8}


def shrink(config, width=64, height=36, level=None):
    """The configuration cut to a test's size, in place."""
    from standin import triangles

    tess = config["model_tessellation"]
    level = TINY_LEVEL[tess] if level is None else level
    config.update(width=width, height=height, model_level=level,
                  model_triangles=triangles(tess, level))
    return config


# three extra instances of the model, the first three of the port's bench
# layout (bench.py:bench_scene, (2.5 (i % 3) - 2.5, 0, 2.5 (i // 3) - 2.5,
# 0.6) for i = 1..3); each shows on a 64x36 frame
EXTRA = [[0.0, 0.0, -2.5, 0.6], [2.5, 0.0, -2.5, 0.6], [-2.5, 0.0, 0.0, 0.6]]


def with_extra(config):
    """The configuration with EXTRA's instances, in place."""
    config.update(instances=2 + len(EXTRA),
                  extra_instances=[list(e) for e in EXTRA])
    return config


@pytest.fixture
def tiny_cell():
    """A function: the named cell of BENCHMARK.json cut to a test's size."""
    import spec

    def make(name="bunny-720p.anim-m1", **over):
        cell = spec.find_cell(name)
        shrink(cell.config, **over)
        return cell
    return make
