"""Aerodynamics: potential flow Δψ = 0 around an airfoil.

JAX rebuild of reference modules/aerodynamics: Laplace operator,
"farfield" BC that pins boundary nodes at u = y − angle·x
(FemModule.cc:200-210), Dirichlet 0 on the airfoil, and the derived
per-cell ψ = −(u_x² + u_y²) post-processing (FemModule.cc:129-141).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


@dataclass
class FarfieldBC:
    surface: str
    angle: float = 0.0


@dataclass
class AerodynamicsConfig:
    farfield: list[FarfieldBC] = field(default_factory=list)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    penalty: float = 1.0e30
    solver: SolverOptions = field(default_factory=SolverOptions)


@dataclass
class AerodynamicsResult:
    u: np.ndarray  # (n_nodes,) potential
    psi: dict  # cell-type -> (nc,) −|∇u|²
    iterations: int
    residual: float
    problem: FemProblem


def solve(mesh: Mesh, config: AerodynamicsConfig, dtype=np.float64,
          timer: PhaseTimer | None = None) -> AerodynamicsResult:
    timer = timer or PhaseTimer(verbose=False)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        pen = dtype_safe_penalty(config.penalty, dtype)
        for ff in config.farfield:
            nodes = mesh.group_nodes(ff.surface)
            vals = jnp.asarray(
                mesh.coords[nodes, 1] - ff.angle * mesh.coords[nodes, 0],
                dtype=dtype,
            )
            prob.apply_dirichlet(system, prob.dof_ids(nodes), vals, "Penalty", pen)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface), bc.value, bc.method,
                dtype_safe_penalty(bc.penalty, dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()
        x.block_until_ready()

    u = prob.node_values(x)[:, 0]
    with timer.phase("update-variables"):
        psi = {}
        for ct, conn in mesh.cells.items():
            xyz = prob.cell_xyz(ct)
            grads = elements.gradients(ct, xyz)
            un = x[jnp.asarray(conn)]
            comps = [jnp.sum(g * un, axis=1) for g in grads]
            psi[ct] = -np.asarray(sum(c * c for c in comps))

    return AerodynamicsResult(
        u=u, psi=psi, iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    farfield = [
        FarfieldBC(
            surface=opt_text(ff, "surface"),
            angle=opt_float(ff, "angle", 0.0),
        )
        for ff in case.fem.findall("farfield-boundary-condition")
    ]
    bcs = BoundaryConditions()
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
            )
        )
    cfg = AerodynamicsConfig(
        farfield=farfield,
        bcs=bcs,
        penalty=opt_float(case.fem, "penalty", 1.0e30),
        solver=case.solver,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Aerodynamics")(_run_arc)


_register()
