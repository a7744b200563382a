"""Per-ray transforms by per-instance matrices: kernel XF and its plain
version.

``y = x . M[inst]`` for every ray, M a row of a small per-instance table
(worlds, inverse worlds, normal matrices, clip transforms).  The plain
version is the expression the frame glue used before the kernel: a
per-ray gather of the matrix (``take_small``) and a batched product
(``einsum``), with the translation row added or the homogeneous 1
appended; on the CPU it is what runs, so CPU frames keep their bits.  The
CUDA kernel (``csrc/xform.cu``) stages the table in shared memory and
computes each ray's product in one thread, so no matrix is gathered per
ray.  It ports no Pallas kernel: the JAX package leaves this product to
XLA.

Forms (``table`` (R, T, T), ``x`` (N, C), output (N, D)):
- ``affine=False``: T = C = D = 3, ``y = x . M`` (the normal matrices);
- ``affine=True, cols=3``: T = 4, C = 3, ``y = x . M[:3, :3] + M[3, :3]``
  (object to world and back);
- ``affine=True, cols=4``: T = 4, C = 3, ``y = [x, 1] . M`` (the clip
  transforms).
Misses (inst -1) read row 0, as ``take_small`` does.
"""

from __future__ import annotations

import functools

import torch

from .. import _precision  # noqa: F401  (float32 matmuls at full precision)
from ..trace.shade import take_small
from .cuda_lib import check_launch, load_library, stream_handle


def instance_xform_plain(table, inst, x, affine=False, cols=None):
    """The glue's own expression for ``instance_xform`` (module
    docstring), bit for bit."""
    m = take_small(table, inst)
    if not affine:
        return torch.einsum("...c,...cd->...d", x, m)
    c = x.shape[-1]
    if (cols or c) == c:
        return torch.einsum("...c,...cd->...d", x, m[..., :c, :c]) \
            + m[..., c, :c]
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return torch.einsum("...c,...cd->...d", xh, m)


@functools.lru_cache(maxsize=None)
def max_rows() -> int:
    """The most table rows a block stages in shared memory."""
    return int(load_library().rtggx_xform_max_rows())


def _check(table, inst, x, affine, cols):
    """Raise unless the inputs are one of the kernel's forms on one CUDA
    device; returns (C, D)."""
    dev = x.device
    if table.device != dev or inst.device != dev:
        raise ValueError(f"instance_xform: table on {table.device}, inst on "
                         f"{inst.device}, x on {dev}: need one device")
    if table.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"instance_xform: need float32 table and x, got "
                         f"{table.dtype} and {x.dtype}")
    if inst.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"instance_xform: need int32 or int64 ids, got "
                         f"{inst.dtype}")
    c = x.shape[-1] if x.dim() == 2 else None
    d = cols or c
    t = 4 if affine else 3
    form_ok = (c == 3 and d in ((3, 4) if affine else (3,))
               and table.dim() == 3 and tuple(table.shape[1:]) == (t, t))
    if not form_ok:
        raise ValueError(f"instance_xform: table {tuple(table.shape)}, x "
                         f"{tuple(x.shape)}, affine={affine}, cols={cols} "
                         f"is none of the forms (3,3)/(N,3)/3, "
                         f"(4,4)/(N,3)/3 affine, (4,4)/(N,3)/4 affine")
    if inst.dim() != 1 or inst.shape[0] != x.shape[0]:
        raise ValueError(f"instance_xform: inst {tuple(inst.shape)} for x "
                         f"{tuple(x.shape)}")
    rows = table.shape[0]
    if not 1 <= rows <= max_rows():
        raise ValueError(f"instance_xform: {rows} table rows; shared memory "
                         f"holds 1 to {max_rows()}")
    return c, d


def instance_xform(table, inst, x, affine=False, cols=None):
    """XF wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors.  ``cols``: the output's columns where the
    form leaves a choice (3, the default, or 4 for a clip transform).
    Launch counters count calls that launch the kernel: a frame captured
    into a CUDA graph (``Renderer.step_n``) counts once, at capture, not
    at each replay."""
    if x.device.type == "cpu":
        return instance_xform_plain(table, inst, x, affine, cols)
    c, d = _check(table, inst, x, affine, cols)
    n = x.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    err = load_library().rtggx_instance_xform(
        table.data_ptr(), table.shape[0], *table.stride(), inst.data_ptr(),
        inst.stride(0), int(inst.dtype == torch.int64), x.data_ptr(),
        *x.stride(), c, d, int(bool(affine)), n, out.data_ptr(),
        stream_handle(x.device))
    check_launch(err, "XF instance_xform")
    instance_xform.launches += 1
    return out


instance_xform.launches = 0
