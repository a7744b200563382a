"""glue_device_ms (layer: frame glue, the torch operations of
``trace.raygen``, ``bvh``, ``ops.scene_wide``'s refit, ``denoise.temporal``
and ``post.tonemap``): device busy time less the port's own kernels
(K1-K5, by name), per frame."""

UNIT = "ms"
MOVES = "frame_ms"
PORT_KERNELS = ("trace_instanced_kernel", "slim_uv_kernel",
                "reflection_pass_kernel", "diffuse_pass_kernel",
                "trace_flat_pairs_kernel", "trace_wide4_kernel")


def read(t):
    if not t.device_ops:
        return None
    kernels_s, _ = t.kernel_s(PORT_KERNELS)
    return (t.busy_s - kernels_s) * 1e3 / t.frames
