"""PyTorch port parity, the kernel lab's ``sub`` and ``smem_nodes`` /
``npop=4`` / ``slim`` / ``noinst`` / unordered variants against the
reference kernel in interpret mode (the slowest reference calls, kept
apart from tests/test_torch_lab.py so that each file stays near a minute
and a half on one process).  Scene, rays and bar as there."""

import pytest

from test_torch_lab import check_against_reference, world  # noqa: F401

CASES = {
    "sub4_lean_recip_stats": dict(sub=4, lean=True, recip=True, stats=True),
    "smem_npop4_slim_noinst_unordered": dict(smem_nodes=True, npop=4,
                                             slim=True, noinst=True,
                                             ordered=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lab_flags_match_reference_kernel(world, case):  # noqa: F811
    check_against_reference(world, CASES[case])
