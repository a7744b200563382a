"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the end-to-end readers (``e2e/<name>.py``),
the per-layer readers (``metrics/<name>.py``), the roofline counts
(``roofline/<kernel>.py``), the peaks (``peaks.json``) and the limits of
the comparison (``limits/<cell>.json``, set from the cell's own readings).
Adding a cell, a mix, a configuration or a metric adds files and
entries; nothing here changes.

Every key of a configuration or a traffic mix is either acted on by the
harness or only describes the deployment (``DESCRIBES``); a key of
``OPTIONAL`` may be left out and then means its default.  A key the
harness does not know, or a value of a known key that it does not
implement, is refused before anything runs: a cell written as data for a
path the harness cannot drive gets an error, never the numbers of
another path."""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

# keys that only describe the deployment
DESCRIBES = {"name", "source", "source_setting", "deployment", "reduced",
             "assumed", "why"}
# keys the harness acts on: a type takes any value of it (handed to the
# program, or checked where the scene is built); a tuple lists the values
# the harness implements
CONFIG_KEYS = {
    "width": int, "height": int, "model_level": int, "model_triangles": int,
    "model_pos_scale": list, "spatial": bool, "temporal": bool,
    "traversal": str, "kernels": str,
    "instances": int,               # 2 + len(extra_instances)
    "spp": (1,),                    # one primary ray a pixel
    "mesh": ("standin",),           # standin.py, from the seed
    "model_tessellation": ("midpoint", "geodesic"),
    "probe": ("procedural_sky",),   # the program's sky where no probe is
    "tone_map": (True,),            # step_n always tone-maps
    "precision": ("float32, TF32 off; float16 TAA history",),
}
# keys that may be left out, with the value they then mean:
# extra_instances, further instances of the model after the first, each
# [x, y, z, scale] as the program's Scene.create(extra_instances=) takes
# them (the model's animation turns each about its own origin)
OPTIONAL = {"extra_instances": []}
TRAFFIC_KEYS = {
    "dt": float, "frames_in_flight": int, "metallic": dict,
    "entry": ("step_n",),           # Renderer.step_n(state, 1) a frame
}
CHIPS = (1,)                        # step_n renders on one card
# the numbers the comparison makes (judge.py): every cell's limits give
# the first two, and tile_mae is compared where its limits give it
NUMBERS = ("frame_mae", "history_rel", "tile_mae")


class Refused(Exception):
    """A run that must print no result."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A reader file as a module of its own (not via sys.path)."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem}".replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict          # the comparison's {number: limit}


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in this cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = HERE.parent, here: Path = HERE) -> Cell:
    """The cell of ``BENCHMARK.json`` at ``root`` named ``name``, with its
    files from ``here``; KeyError when it is not there."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    config = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    check_keys(f"configs/{w['config']}.json", config, CONFIG_KEYS)
    check_keys(f"traffic/{w['traffic']}.json", traffic, TRAFFIC_KEYS)
    check_config(f"configs/{w['config']}.json", config)
    if int(w["chips"]) not in CHIPS:
        raise Refused(f"workload {name}: chips {w['chips']}, but the "
                      f"entry {traffic['entry']} renders on one card")
    limits = load_json(here / "limits" / f"{name}.json")
    for n in NUMBERS[:2]:
        if n not in limits:
            raise Refused(f"limits/{name}.json: no {n!r}")
    for n in limits:
        if n not in NUMBERS:
            raise Refused(f"limits/{name}.json: the comparison makes no "
                          f"{n!r} (it makes {', '.join(NUMBERS)})")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)],
                limits=limits)


def check_keys(where: str, data: dict, keys: dict):
    """Refuse a key the harness does not know, a missing one, or a value
    it does not implement."""
    for k in data:
        if k not in keys and k not in DESCRIBES and k not in OPTIONAL:
            raise Refused(f"{where}: the harness does not act on {k!r}")
    for k, allowed in keys.items():
        if k not in data:
            raise Refused(f"{where}: no {k!r}")
        if not _fits(data[k], allowed):
            raise Refused(f"{where}: {k} {data[k]!r} is not implemented "
                          f"(the harness takes {_name(allowed)})")


def _fits(v, allowed) -> bool:
    if isinstance(allowed, tuple):
        return any(v == a and type(v) is type(a) for a in allowed)
    if allowed is float:
        return type(v) in (int, float)
    return type(v) is allowed


def _name(allowed) -> str:
    return (" or ".join(repr(a) for a in allowed)
            if isinstance(allowed, tuple) else f"a {allowed.__name__}")


def check_config(where: str, config: dict):
    """The model's triangle count is the one its tessellation makes; the
    instance count is the one the layout gives, each extra instance four
    finite numbers with a positive scale."""
    from standin import triangles

    made = triangles(config["model_tessellation"], config["model_level"])
    if made != config["model_triangles"]:
        raise Refused(f"{where}: model_triangles {config['model_triangles']}"
                      f", but {config['model_tessellation']} level "
                      f"{config['model_level']} makes {made}")
    extra = config.get("extra_instances", OPTIONAL["extra_instances"])
    if type(extra) is not list:
        raise Refused(f"{where}: extra_instances {extra!r} is not a list")
    for i, e in enumerate(extra):
        if (type(e) is not list or len(e) != 4
                or any(type(v) not in (int, float) or not math.isfinite(v)
                       for v in e)):
            raise Refused(f"{where}: extra_instances[{i}] {e!r} is not "
                          "[x, y, z, scale] of four finite numbers")
        if e[3] <= 0:
            raise Refused(f"{where}: extra_instances[{i}] has scale {e[3]!r}"
                          ", not above 0")
    if config["instances"] != 2 + len(extra):
        raise Refused(f"{where}: instances {config['instances']}, but the "
                      f"ground, the model and {len(extra)} extra_instances "
                      f"make {2 + len(extra)}")


def extra_instances(config: dict) -> tuple:
    """The configuration's extra instances as ((x, y, z, scale), ...)."""
    return tuple(tuple(float(v) for v in e) for e in
                 config.get("extra_instances", OPTIONAL["extra_instances"]))


def reader(kind: str, name: str, here: Path = HERE):
    """The module of ``<kind>/<name>.py`` (kind: e2e, metrics, roofline)."""
    return load_module(here / kind / f"{name}.py")


def peaks(here: Path = HERE) -> dict:
    return load_json(here / "peaks.json")
