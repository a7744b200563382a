"""The traversal kernel lab: K6a/K6b (``fused_lab``) and K7 (``fused_mxu``),
priced by ``raytracedggx_tpu_torch.scripts.kbench``."""
