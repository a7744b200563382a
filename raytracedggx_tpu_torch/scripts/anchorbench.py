"""Anchor-augmented bounce sort A/B: the same kernel on the same wave in
three orders.

Port of scripts/anchorbench.py.  A packet or a warp pays the union of its
rays' visits, and the bounce key dead | octant | Morton groups rays by
where they START; adding each ray's anchor (the id of the nearest box of a
~K-box cut of its mesh's subtree that it enters,
ops/scene_wide.anchor_ids_scene) groups them by where they GO.  On
kbench's reflection set (``scripts/kbench.py``: the stand-in scene at
``KB_RES``, GGX bounce rays from K1's primary hits, traced from
``T_MIN_REFL``), for the scene BVH at the renderer's leaf size (8) and at
64, the reference's setting, each order is timed and its visits counted:

  base         dead | octant | Morton            (the frame's default key)
  anchor       dead | octant | anchor | Morton   (RenderConfig.sort_anchor)
  anchor_only  dead | anchor | Morton

The reference's bench put its ``anchor`` row's anchor before the octant;
this one prices the key that ``sort_anchor`` sorts by
(ops/ordering.sort_rays_morton).  Per order and tree: K1's median ms over
``frames`` launches, the ms of building the order (anchor ids, key,
sort), K6a's ``stats`` visits (kbench's ``visit_summary``: per ray, and
the mean over 32-ray warps of the warp's maximum), and the largest |dt| of
K1's t after un-permutation against ``base``.  It prints one JSON line and
exits non-zero when a parity exceeds kbench's gate.

    python -m raytracedggx_tpu_torch.scripts.anchorbench [frames] [K_cut]
        [--device cpu]

Runs on the card and raises without one; ``--device cpu`` runs the plain
versions for a small-``KB_RES`` rehearsal.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from . import kbench

LEAVES = (8, 64)
ORDERS = ("base", "anchor", "anchor_only")


def _bounds(sw):
    """The scene's box for the Morton code: the root's children, as kbench
    sorts its reflection set."""
    boxes0 = sw.nodes[0, :24].reshape(4, 6)
    return boxes0[:, 0:3].amin(dim=0), boxes0[:, 3:6].amax(dim=0)


def order_fns(sw, o, d, t_max):
    """{order name: () -> permutation} over rays (o, d, t_max); sw holds
    the anchor cut."""
    from ..bvh.morton import morton3d
    from ..ops.ordering import sort_rays_morton
    from ..ops.scene_wide import anchor_bits, anchor_ids_scene

    lo, hi = _bounds(sw)
    live = t_max > 0
    ab = anchor_bits(sw)

    def base():
        return sort_rays_morton(o, d, lo, hi, active=live)[0]

    def anchor():
        aid = anchor_ids_scene(sw, o, d)
        return sort_rays_morton(o, d, lo, hi, active=live, anchor=aid,
                                anchor_bits=ab)[0]

    def anchor_only():
        aid = anchor_ids_scene(sw, o, d)
        key = ((aid << (31 - ab))
               | (morton3d(o, lo, hi) >> max(ab - 1, 0))) & 0xFFFFFFFF
        key = torch.where(live, key, key | (1 << 31))
        return torch.sort(key, stable=True).indices

    return dict(base=base, anchor=anchor, anchor_only=anchor_only)


def run(bench, frames, k_cut):
    """{leaf: dict(anchors, anchor_bits, orders={name: row})}; row: k1_ms,
    order_ms, parity, and K6a's visit summary."""
    from ..ops.scene_wide import anchor_bits, build_scene_wide

    o, d, t = bench.o_r, bench.d_r, bench.t_r
    out = {}
    for leaf in LEAVES:
        sw = bench.tree(leaf)
        if k_cut != 32:           # Bench's trees carry the default cut
            sw = build_scene_wide(bench.geom, bench.scene.mesh_ids,
                                  leaf_size=leaf, worlds=bench.worlds,
                                  device=bench.device, anchor_cut=k_cut)
        k1 = dict(k1=True) if leaf == 8 else dict(k1=True, l64=True)
        lab = dict(stats=True) if leaf == 8 else dict(stats=True, l64=True)
        assert bench.variant_tree(k1)[1] == leaf == bench.variant_tree(lab)[1]
        rows, t_base = {}, None
        for name, fn in order_fns(sw, o, d, t).items():
            order = fn()
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.shape[0], device=order.device)
            o_s, d_s, t_s = (o[order].contiguous(), d[order].contiguous(),
                             t[order].contiguous())
            row = dict(order_ms=kbench.time_ms(fn, frames, bench.device))
            row["k1_ms"] = kbench.time_ms(
                lambda: bench.launch(k1, o_s, d_s, t_s,
                                     t_min=kbench.T_MIN_REFL),
                frames, bench.device)
            t_row = bench.launch(k1, o_s, d_s, t_s,
                                 t_min=kbench.T_MIN_REFL)[0][inv]
            if t_base is None:
                t_base = t_row
            row["parity"] = float((t_row - t_base).abs().max())
            counts = bench.launch(lab, o_s, d_s, t_s,
                                  t_min=kbench.T_MIN_REFL)[6]
            row.update(kbench.visit_summary(counts, t_s))
            rows[name] = row
            print(f"L{leaf:<3d} {name:12s} K1 {row['k1_ms']:8.4f} ms  order "
                  f"{row['order_ms']:8.4f} ms  warp-max nodes "
                  f"{row['warp_node_mean']:.4f} leaves "
                  f"{row['warp_leaf_mean']:.4f}  nodes/ray "
                  f"{row['node_mean']:.4f} leaves/ray {row['leaf_mean']:.4f}"
                  f"  parity {row['parity']:.2e}", flush=True)
        out[str(leaf)] = dict(anchors=sw.anchor_base[-1],
                              anchor_bits=anchor_bits(sw), orders=rows)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    frames = int(argv[0]) if argv else 10
    k_cut = int(argv[1]) if len(argv) > 1 else 32
    card = None
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("anchorbench needs a CUDA device (--device cpu "
                             "runs the plain versions for a rehearsal)")
        card = kbench.card_line()
        print(card, flush=True)
    W, H = (int(v) for v in os.environ.get("KB_RES", "1280x720").split("x"))
    bench = kbench.Bench(device, W, H, int(os.environ.get("KB_SUBDIV", "6")),
                         float(os.environ.get("KB_ROUGH_A", "0.25")))
    live = int((bench.t_r > 0).sum())
    print(f"reflection set: {bench.o_r.shape[0]} rays, {live} live; cut "
          f"{k_cut} per mesh; device {bench.device}", flush=True)
    res = run(bench, frames, k_cut)
    print(json.dumps(dict(card=card, frames=frames, k_cut=k_cut, live=live,
                          rays=bench.o_r.shape[0], leaves=res)), flush=True)
    worst = max(r["parity"] for v in res.values()
                for r in v["orders"].values())
    return 0 if worst <= kbench.PARITY_BAR else 1


if __name__ == "__main__":
    sys.exit(main())
