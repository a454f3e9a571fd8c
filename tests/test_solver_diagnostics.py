"""Solve diagnostics: true-residual reporting and the failure artifact.

The reference's Aleph backend dumps the matrix to SolveErrorAlephMatrix.dbg
when a solve fails with stop_error_strategy (AlephDoFLinearSystem.cc:360-362),
and Hypre's reported convergence measure is relative to ||b||
(HypreDoFLinearSystemFactory.axl:4-13).  These tests cover this build's
equivalents: info["true_residual"] and SolveErrorMatrix.npz.
"""

import warnings
from dataclasses import replace

import numpy as np
import pytest

from arcanefem_tpu.fem.problem import FemProblem
from arcanefem_tpu.mesh import rect_tria_mesh
from arcanefem_tpu.ops import elements
from arcanefem_tpu.solver.linear_system import SolverOptions


def _poisson_system(**opts):
    mesh = rect_tria_mesh(6, 6)
    prob = FemProblem(mesh, ndof=1)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    sys = prob.new_system(A, SolverOptions(**opts))
    sys.rhs = prob.constant_source_rhs(3.0)
    prob.apply_dirichlet(sys, prob.group_dofs("left"), 1.5, "Penalty", 1e30)
    return sys


def test_true_residual_reported_and_small():
    sys = _poisson_system(rtol=1e-12)
    x, info = sys.solve()
    assert "true_residual" in info
    # cold solve to rtol 1e-12: the unpreconditioned ||b-Ax||/||b|| must be
    # comparably converged (penalty rows dominate ||b||, so it is usually
    # even smaller than the monitored preconditioned-norm residual)
    assert float(info["true_residual"]) < 1e-8


def test_nonconverged_solve_dumps_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("AFEM_SOLVE_DEBUG_DIR", str(tmp_path))
    sys = _poisson_system(rtol=1e-14, max_iter=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        x, info = sys.solve()
    assert any("did NOT converge" in str(wi.message) for wi in w)
    art = tmp_path / "SolveErrorMatrix.npz"
    assert art.exists()
    data = np.load(art)
    assert data["rhs"].shape == (49,)
    assert data["bell_values"].size > 0
    assert int(data["iterations"]) == 2
    assert str(data["method"]) == "cg"


def test_fail_action_raise():
    sys = _poisson_system(rtol=1e-14, max_iter=2)
    sys.options = replace(sys.options, fail_action="raise")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="failed to converge"):
            sys.solve()


def test_fail_action_ignore_is_silent():
    sys = _poisson_system(rtol=1e-14, max_iter=2)
    sys.options = replace(sys.options, fail_action="ignore")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, info = sys.solve()  # must not warn or raise
    assert int(info["iterations"]) == 2
