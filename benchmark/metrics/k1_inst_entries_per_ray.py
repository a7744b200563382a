"""k1_inst_entries_per_ray (layer: traversal, ``ops.fused`` and
``csrc/traverse.cu``): the instances K1 enters per live ray, every wave,
as K1 counts them into the program's counters (``engine.spans.counts``,
``"k1_inst_entries"``): each instance entry is a top-tree child that K1
pushes, one instance's object-space subtree that the ray then walks
with one more transform.  Their total over the frames the program ran,
per frame, over the frame's live rays summed over its waves.  Work done,
not time: overlapping instance boxes show here as more entries a ray.
None where the program has no such counter or it counted nothing."""

UNIT = "entries"
MOVES = "frame_ms"
KEY = "k1_inst_entries"


def read(t):
    try:
        from raytracedggx_tpu_torch.engine import spans
    except ImportError:
        return None
    counts = spans.counts()
    entries, frames = sum(counts.get(KEY, ())), counts["frames"]
    rays = sum(t.live_rays.values())
    if not entries or not frames or not rays:
        return None
    return entries / frames / rays
