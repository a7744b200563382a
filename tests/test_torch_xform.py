"""The waves' per-instance transforms (``ops/xform_cuda.py``, XF) on the
CPU: for every call form of ``trace/raygen.py`` the wrapper takes its
plain version, which equals the expression the glue had before the
kernel (a per-ray ``take_small`` of the matrix and an ``einsum``) bit for
bit; and the kernel's input checks refuse what the kernel cannot take.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracedggx_tpu_torch.ops import xform_cuda
from raytracedggx_tpu_torch.trace import raygen
from raytracedggx_tpu_torch.trace.shade import take_small

N = 4096


def _einsum(x, m):
    return torch.einsum("...c,...cd->...d", x, m)


def _affine3(table, inst, x):
    """world_to_object's and the per-mesh routes' object-to-world product
    before the kernel."""
    m = take_small(table, inst)
    return _einsum(x, m[..., :3, :3]) + m[..., 3, :3]


def _clip(table, inst, x):
    """The velocity's and the depth's clip transforms before the kernel."""
    pos_h = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return _einsum(pos_h, take_small(table, inst))


# call site: (the new call, the old expression)
SITES = {
    "world_to_object": (
        raygen.world_to_object,
        lambda c, i, x: _affine3(c.inv_worlds, i, x)),
    "normal": (
        lambda c, i, x: xform_cuda.instance_xform(c.world_its, i, x),
        lambda c, i, x: _einsum(x, take_small(c.world_its, i))),
    "worlds": (
        lambda c, i, x: xform_cuda.instance_xform(c.worlds, i, x,
                                                  affine=True),
        lambda c, i, x: _affine3(c.worlds, i, x)),
    "prev_clip": (
        lambda c, i, x: xform_cuda.instance_xform(
            c.world_view_projs_prev, i, x, affine=True, cols=4),
        lambda c, i, x: _clip(c.world_view_projs_prev, i, x)),
    "cur_clip": (
        lambda c, i, x: xform_cuda.instance_xform(
            c.world_view_projs, i, x, affine=True, cols=4),
        lambda c, i, x: _clip(c.world_view_projs, i, x)),
}


def _consts(rng, rows):
    def mats(k):
        return torch.as_tensor(rng.normal(0.0, 2.0, (rows, k, k)),
                               dtype=torch.float32)
    return SimpleNamespace(inv_worlds=mats(4), world_its=mats(3),
                           worlds=mats(4), world_view_projs=mats(4),
                           world_view_projs_prev=mats(4))


@pytest.mark.parametrize("layout", ["contiguous_i64", "strided_i32"])
@pytest.mark.parametrize("site", list(SITES))
def test_cpu_wrapper_is_the_replaced_expression(site, layout):
    """Misses (-1) and hits of 2 instances; strided: x and the ids as
    columns of wider rows, as a wave's un-permuted rows hand them over."""
    rng = np.random.default_rng(len(site) + len(layout))
    consts = _consts(rng, 2)
    inst = torch.as_tensor(rng.integers(-1, 2, N))
    x = torch.as_tensor(rng.normal(0.0, 5.0, (N, 3)), dtype=torch.float32)
    if layout == "strided_i32":
        inst = torch.stack([inst, inst], dim=-1).to(torch.int32)[:, 1]
        x = torch.cat([x, x], dim=-1)[:, 3:6]
    new, old = SITES[site]
    n0 = xform_cuda.instance_xform.launches
    got, want = new(consts, inst, x), old(consts, inst, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert xform_cuda.instance_xform.launches == n0   # no kernel here


def _bad_inputs():
    t4 = torch.zeros((2, 4, 4))
    ids = torch.zeros(8, dtype=torch.int64)
    x = torch.zeros((8, 3))
    return {
        "float64_table": (t4.double(), ids, x, True, None),
        "float64_x": (t4, ids, x.double(), True, None),
        "float_ids": (t4, ids.float(), x, True, None),
        "table_not_affine": (t4, ids, x, False, None),
        "table_3x3_affine": (t4[:, :3, :3], ids, x, True, None),
        "cols_2": (t4, ids, x, True, 2),
        "cols_4_not_affine": (t4[:, :3, :3], ids, x, False, 4),
        "x_two_columns": (t4, ids, x[:, :2], True, None),
        "x_3d": (t4, ids, x[None], True, None),
        "ids_short": (t4, ids[:-1], x, True, None),
        "ids_2d": (t4, ids[:, None], x, True, None),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_checks_refuse_bad_inputs(case):
    """The checks a CUDA call runs before its launch refuse a dtype,
    shape or form the kernel cannot take (each before the row count,
    which needs the built library)."""
    with pytest.raises(ValueError):
        xform_cuda._check(*_bad_inputs()[case])
