"""End-to-end golden-file regression over the reference's Poisson cases.

The reference's test strategy (SURVEY.md §4): each .arc case runs the
full module and validates per-node values against check/*.txt with
relative epsilon 1e-4 (modules/poisson/CMakeLists.txt:44-107).  Here we run
the *same* case files and golden files through the JAX stack.
"""

import glob

import pytest

from arcanefem_tpu.fem.runner import run_case
from conftest import REFERENCE

POISSON_CASES = sorted(glob.glob(f"{REFERENCE}/modules/poisson/inputs/*.arc"))
LAPLACE_CASES = sorted(glob.glob(f"{REFERENCE}/modules/laplace/inputs/*.arc"))


@pytest.mark.parametrize("arc", POISSON_CASES, ids=lambda p: p.split("/")[-1])
def test_poisson_case(arc):
    res = run_case(arc)  # raises AssertionError on golden mismatch
    assert res.residual < 1e-6 or res.iterations >= 1


@pytest.mark.parametrize("arc", LAPLACE_CASES, ids=lambda p: p.split("/")[-1])
def test_laplace_case(arc):
    try:
        run_case(arc)
    except FileNotFoundError as e:
        # some reference cases use meshes generated by Gmsh at build time
        pytest.skip(str(e))
