"""raytracedggx_tpu_torch — the PyTorch + CUDA port of raytracedggx_tpu.

Same layout and names as the JAX package (``scene/ trace/ sh/ bvh/ ops/
denoise/ post/ engine/ utils/``), so each module has an obvious
counterpart there.  Array code is torch; the three hand-written kernels
of the default frame path (closest-hit traversal K1, reflection and
diffuse spatial filter passes K2/K3) are CUDA C++ under ``csrc/``, built
with nvcc at first use.  Every kernel wrapper falls back to its plain
torch version only for tensors on the CPU.  The package's own import
loads no torch (``bench``'s parent process needs none); ``_precision``
keeps float32 matmuls off TF32.

This package never imports jax or raytracedggx_tpu.
"""

__version__ = "0.1.0"
