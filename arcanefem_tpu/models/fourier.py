"""Fourier steady heat conduction: −∇·(λ∇T) = qdot.

JAX rebuild of reference modules/fourier: per-region material λ
(`<material-property><volume>..<lambda>`, FemModule.cc:133-148), constant
source qdot, Dirichlet/Neumann via the shared BC service, and manufactured
solutions.  The reference wires manufactured functions through C# user
code + IStandardFunction (ExternalFunctions.cs:30-38, FemModule.cc:35-55);
here they are Python callables traced into the jitted RHS assembly, with
the reference's sample functions available by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..fem.bcs import BoundaryConditions, ManufacturedSolution, dtype_safe_penalty
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


def make_standard_functions(lam: float):
    """The reference's C# sample functions (ExternalFunctions.cs:30-38):
    manufacturedDirichlet(λ, p) = λ(sin x + cos y), same for the source."""

    def fn(x, y, z):
        return lam * (jnp.sin(x) + jnp.cos(y))

    return {"manufacturedDirichlet": fn, "manufacturedSource": fn}


@dataclass
class FourierConfig:
    lam: float = 1.0  # <lambda>
    qdot: float | None = None
    materials: list[tuple[str, float]] = field(default_factory=list)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4


@dataclass
class FourierResult:
    u: np.ndarray
    iterations: int
    residual: float
    problem: FemProblem


def solve(mesh: Mesh, config: FourierConfig, dtype=np.float64,
          timer: PhaseTimer | None = None) -> FourierResult:
    timer = timer or PhaseTimer(verbose=False)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype)

    # per-cell λ: default then per-region override (FemModule.cc:133-148)
    cell_lambda = {
        ct: np.full(conn.shape[0], config.lam, dtype)
        for ct, conn in mesh.cells.items()
    }
    for region, lam in config.materials:
        for ct, sel in mesh.cell_groups.get(region, {}).items():
            # cell_groups store connectivity; match rows against the bucket
            idx = _rows_in_bucket(mesh.cells[ct], sel)
            cell_lambda[ct][idx] = lam

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: jnp.asarray(cell_lambda[ct])[:, None, None]
            * elements.stiffness(ct, xyz)
        )

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        if config.qdot is not None:
            system.rhs = prob.constant_source_rhs(config.qdot)
        for nm in config.bcs.neumann:
            if nm.value is not None:
                system.rhs = prob.neumann_rhs(system.rhs, nm.surface, value=nm.value)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface), bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, dtype),
            )
        ms = config.bcs.manufactured
        if ms is not None:
            from .poisson import _manufactured_source_rhs, _all_boundary_nodes

            if ms.source is not None:
                system.rhs = system.rhs + _manufactured_source_rhs(prob, ms.source)
            if ms.dirichlet is not None:
                bnodes = _all_boundary_nodes(prob)
                xyz = mesh.coords[bnodes]
                vals = jnp.asarray(
                    ms.dirichlet(
                        jnp.asarray(xyz[:, 0]), jnp.asarray(xyz[:, 1]), jnp.asarray(xyz[:, 2])
                    ),
                    dtype=dtype,
                )
                prob.apply_dirichlet(
                    system, prob.dof_ids(bnodes), vals, ms.method,
                    dtype_safe_penalty(ms.penalty, dtype),
                )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()
        x.block_until_ready()

    u = prob.node_values(x)[:, 0]
    result = FourierResult(
        u=u, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file, config.result_epsilon
            )
    return result


def _rows_in_bucket(bucket: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """Indices of `sel` connectivity rows inside the full bucket."""
    key = {tuple(r): i for i, r in enumerate(map(tuple, bucket))}
    return np.asarray([key[tuple(r)] for r in map(tuple, sel)], np.int64)


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    from ..fem.arc import opt_float, opt_text

    lam = opt_float(case.fem, "lambda", 1.0)
    materials = []
    for mp in case.fem.findall("material-property"):
        materials.append(
            (opt_text(mp, "volume"), opt_float(mp, "lambda", lam))
        )
    bcs = case.bcs
    # manufactured-solution block with named standard functions
    bce = case.fem.find("boundary-conditions")
    if bce is not None:
        msel = bce.find("manufactured-solution")
        if msel is not None:
            fns = make_standard_functions(lam)
            md = msel.find("manufactured-dirichlet")
            msrc = msel.find("manufactured-source")
            bcs.manufactured = ManufacturedSolution(
                dirichlet=fns[md.get("function")] if md is not None else None,
                source=fns[msrc.get("function")] if msrc is not None else None,
                method=opt_text(msel, "enforce-Dirichlet-method", "Penalty"),
                penalty=opt_float(msel, "penalty", 1.0e30),
            )
    cfg = FourierConfig(
        lam=lam,
        qdot=opt_float(case.fem, "qdot"),
        materials=materials,
        bcs=bcs,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Fourier")(_run_arc)


_register()
