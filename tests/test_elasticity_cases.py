"""Elasticity golden-file regression over the reference's case files.

Covers traction/bodyforce RHS, point-Dirichlet and all three Dirichlet
enforcement methods (reference modules/elasticity/CMakeLists.txt test list).
"""

import glob

import pytest

from arcanefem_tpu.fem.runner import run_case
from conftest import REFERENCE

CASES = sorted(glob.glob(f"{REFERENCE}/modules/elasticity/inputs/*.arc"))


@pytest.mark.parametrize("arc", CASES, ids=lambda p: p.split("/")[-1])
def test_elasticity_case(arc):
    res = run_case(arc)
    assert res.u.shape[1] == 2
