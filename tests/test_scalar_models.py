"""Golden-file regression for fourier / electrostatics / acoustics /
aerodynamics / bilaplacian over the reference's case files (SURVEY.md §2.2).
"""

import glob

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case
from conftest import REFERENCE


def _cases(mod):
    return sorted(glob.glob(f"{REFERENCE}/modules/{mod}/inputs/*.arc"))


def _run(arc):
    try:
        return run_case(arc)
    except FileNotFoundError as e:
        pytest.skip(str(e))


@pytest.mark.parametrize("arc", _cases("fourier"), ids=lambda p: p.split("/")[-1])
def test_fourier(arc):
    _run(arc)


@pytest.mark.parametrize("arc", _cases("electrostatics"), ids=lambda p: p.split("/")[-1])
def test_electrostatics(arc):
    r = _run(arc)
    # derived field present for every bucket
    assert set(r.E) == set(r.problem.mesh.cells)


@pytest.mark.parametrize("arc", _cases("acoustics"), ids=lambda p: p.split("/")[-1])
def test_acoustics(arc):
    _run(arc)


@pytest.mark.parametrize("arc", _cases("aerodynamics"), ids=lambda p: p.split("/")[-1])
def test_aerodynamics(arc):
    r = _run(arc)
    # potential-flow sanity: psi = −|∇u|² nonpositive, u finite
    assert np.all(np.isfinite(r.u))
    for ps in r.psi.values():
        assert np.all(ps <= 1e-12)


@pytest.mark.parametrize("arc", _cases("bilaplacian"), ids=lambda p: p.split("/")[-1])
def test_bilaplacian(arc):
    r = _run(arc)
    assert np.all(np.isfinite(r.u1)) and np.all(np.isfinite(r.u2))


def test_bilaplacian_block_structure(reference_dir):
    """Assembled mixed system has the [[0,S],[S,M]] block structure: the
    (u1,u1) diagonal block is exactly zero, S blocks symmetric."""
    from arcanefem_tpu.fem.arc import load_case
    from arcanefem_tpu.mesh.core import read_msh
    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.models import bilaplacian as B

    case = load_case(f"{reference_dir}/modules/bilaplacian/inputs/internal_pcg.arc")
    mesh = read_msh(case.mesh_file)
    prob = FemProblem(mesh, ndof=2, dtype=np.float64)
    A = prob.assemble_matrix(B.element_blocks)
    D = np.asarray(A.todense())
    n = mesh.n_nodes
    u1 = np.arange(n) * 2
    assert np.abs(D[np.ix_(u1, u1)]).max() == 0.0
    np.testing.assert_allclose(D, D.T, atol=1e-12)


def _bilap_bcs(case):
    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC

    return BoundaryConditions(
        dirichlet=[DirichletBC(surface="boundary", value=0.05)]
    )


def _dense():
    from arcanefem_tpu.solver.linear_system import SolverOptions

    return SolverOptions(method="dense")


def _bicg():
    from arcanefem_tpu.solver.linear_system import SolverOptions

    return SolverOptions(method="bicgstab", preconditioner="none", rtol=1e-12, max_iter=4000)
