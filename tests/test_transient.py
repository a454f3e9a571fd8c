"""Transient models: heat + elastodynamics.

No golden files exist for these in the reference (modules/heat and
modules/elastodynamics ship no check/ directories), so correctness is
verified by physics limits: the damped/long-time transient solution must
converge to the corresponding static solution, and all reference cases
must run and stay bounded.
"""

import glob

import numpy as np
import pytest

from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC, TractionBC
from arcanefem_tpu.fem.runner import run_case
from arcanefem_tpu.mesh.generate import rect_tria_mesh
from arcanefem_tpu.solver.linear_system import SolverOptions
from conftest import REFERENCE


HEAT_CASES = sorted(glob.glob(f"{REFERENCE}/modules/heat/inputs/*.arc"))
ELASTO_CASES = sorted(
    glob.glob(f"{REFERENCE}/modules/elastodynamics/inputs/*.arc")
)


@pytest.mark.parametrize("arc", HEAT_CASES, ids=lambda p: p.split("/")[-1])
def test_heat_case(arc):
    try:
        r = run_case(arc)
    except FileNotFoundError as e:
        pytest.skip(str(e))
    assert np.all(np.isfinite(r.T))


@pytest.mark.parametrize("arc", ELASTO_CASES, ids=lambda p: p.split("/")[-1])
def test_elastodynamics_case(arc):
    try:
        r = run_case(arc)
    except FileNotFoundError as e:
        pytest.skip(str(e))
    assert np.all(np.isfinite(r.u))


def test_heat_steady_state_limit():
    """Long-time implicit heat with left/right Dirichlet → linear profile."""
    from arcanefem_tpu.models import heat as H

    mesh = rect_tria_mesh(10, 6, lx=1.0)
    # NOTE the scheme inherits the reference's lumped-RHS (T_old/dt,
    # FemModule.cc:487-493) vs consistent-M/dt-LHS mix, which biases the
    # steady state by O(h²/(λ·dt)); a larger dt shrinks the bias.
    cfg = H.HeatConfig(
        lam=1.0, Tinit=0.5, dt=1.0, tmax=80.0,
        bcs=BoundaryConditions(dirichlet=[
            DirichletBC(surface="left", value=0.0),
            DirichletBC(surface="right", value=1.0),
        ]),
        solver=SolverOptions(rtol=1e-10),
    )
    r = H.solve(mesh, cfg)
    np.testing.assert_allclose(r.T, mesh.coords[:, 0], atol=1e-3)
    # steady linear profile T=x, λ=1 → flux = −λ∇T = (−1, 0) on every cell
    # (the reference's post-processing Flux, FemModule.cc:867-892)
    # (same O(h²/(λ·dt)) lumping bias as T: ~2e-3 at this resolution)
    np.testing.assert_allclose(r.flux["tria3"][:, 0], -1.0, atol=4e-3)
    np.testing.assert_allclose(r.flux["tria3"][:, 1], 0.0, atol=4e-3)


def test_newmark_damped_reaches_static_solution():
    """Heavily damped Newmark elastodynamics → static elasticity solution
    under the same traction (cross-module validation)."""
    from arcanefem_tpu.models import elasticity as ES
    from arcanefem_tpu.models import elastodynamics as ED

    mesh = rect_tria_mesh(10, 3, lx=5.0, ly=1.0)
    lam, mu = 576.9230769, 384.6153846
    bcs_dyn = BoundaryConditions(
        dirichlet=[DirichletBC(surface="left", values=(0.0, 0.0))]
    )
    cfg = ED.ElastodynamicsConfig(
        time_discretization="Newmark-beta",
        tmax=60.0, dt=0.25, rho=1.0, lam=lam, mu=mu,
        etam=1.2, etak=0.02,
        bcs=bcs_dyn,
        tractions=[ED.TractionTBC(surface="right", t=(None, 0.01))],
        solver=SolverOptions(rtol=1e-10, max_iter=3000),
    )
    rdyn = ED.solve(mesh, cfg)

    E = mu * (3 * lam + 2 * mu) / (lam + mu)
    nu = lam / (2 * (lam + mu))
    rstat = ES.solve(
        mesh,
        ES.ElasticityConfig(
            E=E, nu=nu,
            bcs=BoundaryConditions(
                dirichlet=[DirichletBC(surface="left", values=(0.0, 0.0))],
                traction=[TractionBC(surface="right", t=(None, 0.01))],
            ),
            solver=SolverOptions(rtol=1e-12, max_iter=3000),
        ),
    )
    scale = np.abs(rstat.u).max()
    assert scale > 0
    np.testing.assert_allclose(rdyn.u, rstat.u, atol=0.02 * scale)


def test_generalized_alpha_bounded():
    from arcanefem_tpu.models import elastodynamics as ED

    mesh = rect_tria_mesh(8, 2, lx=4.0, ly=1.0)
    cfg = ED.ElastodynamicsConfig(
        time_discretization="Generalized-alpha",
        alpm=0.2, alpf=0.4,
        tmax=4.0, dt=0.1, rho=1.0, lam=500.0, mu=300.0,
        bcs=BoundaryConditions(
            dirichlet=[DirichletBC(surface="left", values=(0.0, 0.0))]
        ),
        tractions=[ED.TractionTBC(surface="right", t=(None, 0.01))],
        solver=SolverOptions(rtol=1e-9),
    )
    r = ED.solve(mesh, cfg)
    assert np.abs(r.u).max() < 1.0


def test_case_table_interpolation(reference_dir):
    from arcanefem_tpu.fem.casetable import read_case_table

    t = read_case_table(
        f"{reference_dir}/modules/elastodynamics/data/traction_bar_test_1.txt", 3
    )
    v0 = np.asarray(t.value(float(t.times[0])))
    np.testing.assert_allclose(v0, t.values[0], rtol=1e-12)
    tm = 0.5 * (t.times[0] + t.times[1])
    vm = np.asarray(t.value(float(tm)))
    np.testing.assert_allclose(vm, 0.5 * (t.values[0] + t.values[1]), rtol=1e-9)


def test_newmark_consistent_a0_restores_second_order():
    """The reference leaves m_A zero-initialized, which degrades Newmark to
    first order under a step body force (measured order ~0.9); with
    initial_acceleration="consistent" (solve rho*M*A0 = F(0) - K*U0) the
    observed order returns to ~2 and errors drop ~10x."""
    import numpy as np

    from arcanefem_tpu.mesh.generate import box_tetra_mesh
    from arcanefem_tpu.models.elastodynamics import (
        ElastodynamicsConfig,
        solve as edsolve,
    )
    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC

    mesh = box_tetra_mesh(3, 2, 2)

    def run(dt, ia):
        cfg = ElastodynamicsConfig(
            tmax=0.4, dt=dt, rho=1.0, E=5.0, nu=0.3, f=(0.0, 0.0, -1.0),
            bcs=BoundaryConditions(
                dirichlet=[DirichletBC(surface="xmin", values=(0.0, 0.0, 0.0))]
            ),
            penalty=1.0e12, initial_acceleration=ia,
        )
        cfg.solver.rtol = 1e-12
        return np.asarray(edsolve(mesh, cfg).u)

    u1, u2, u4 = run(0.1, "consistent"), run(0.05, "consistent"), run(0.025, "consistent")
    e12 = np.linalg.norm(u1 - u2)
    e24 = np.linalg.norm(u2 - u4)
    order = np.log2(e12 / e24)
    assert order > 1.5, (order, e12, e24)  # measured 1.78

    z1, z2 = run(0.1, "zero"), run(0.05, "zero")
    # parity path runs and is visibly less accurate (measured ~10x)
    assert np.linalg.norm(z1 - z2) > 3 * e12
