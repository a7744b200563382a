"""raytracedggx_tpu_torch — the PyTorch + CUDA port of raytracedggx_tpu.

Same layout and names as the JAX package (``scene/ trace/ sh/ bvh/ ops/
denoise/ post/ engine/ utils/``), so each module has an obvious
counterpart there.  Array code is torch; the three hand-written kernels
of the default frame path (closest-hit traversal K1, reflection and
diffuse spatial filter passes K2/K3) are CUDA C++ under ``csrc/``, built
with nvcc at first use.  Every kernel wrapper falls back to its plain
torch version only for tensors on the CPU.

This package never imports jax or raytracedggx_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# Mirror the reference's jax_default_matmul_precision="highest": the
# camera/instance transforms, unprojection and 4x4 inverses are tiny but
# precision-critical (TF32 rounding of a world matrix shows up as ~1e-3
# NDC reprojection error, which breaks motion vectors and TAA lookups).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
