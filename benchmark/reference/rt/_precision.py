"""Float32 matmuls at full precision, as the reference's
jax_default_matmul_precision="highest": the camera / instance transforms,
unprojection and 4x4 inverses are tiny but precision-critical (TF32
rounding of a world matrix shows up as ~1e-3 NDC reprojection error,
which breaks motion vectors and TAA lookups).  PyTorch's matmul
defaults agree; this pins them, and cuDNN's, against a caller or an
environment that changed them.
Each module that does a float32 matmul imports it (a module that only
calls into one gets it from there); the package itself does not import
torch (the bench's parent process, ``bench.py``, never does)."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
