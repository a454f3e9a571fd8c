"""Bilaplacian via the mixed two-field formulation.

JAX rebuild of reference modules/bilaplacian: 2 DoFs per node
(u1, u2), the 6×6 element matrix built there from B-matrix products
(FemModule.cc:398-545) reduces to the block form

    K(i,j) = [[ 0     S_ij ],
              [ S_ij  M_ij ]]

with S the P1 stiffness and M the P1 mass matrix — i.e. the mixed system
{ ∫∇u2·∇v1 = ∫f v1 ;  ∫∇u1·∇v2 + ∫u2 v2 = 0 }.  Source f and Dirichlet
values act on the u1 component only (FemModule.cc:246,344).
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


def element_blocks(cell_type: str, xyz) -> jnp.ndarray:
    S = elements.stiffness(cell_type, xyz)  # (nc, npc, npc)
    M = elements.mass(cell_type, xyz)
    Z = jnp.zeros_like(S)
    return jnp.stack(
        [jnp.stack([Z, S], axis=-1), jnp.stack([S, M], axis=-1)], axis=-2
    )  # (nc, npc, npc, 2, 2)


@dataclass
class BilaplacianConfig:
    f: float | None = None
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)


@dataclass
class BilaplacianResult:
    u1: np.ndarray
    u2: np.ndarray
    iterations: int
    residual: float
    problem: FemProblem


def solve(mesh: Mesh, config: BilaplacianConfig, dtype=np.float64,
          timer: PhaseTimer | None = None) -> BilaplacianResult:
    timer = timer or PhaseTimer(verbose=False)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=2, dtype=dtype)

    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(element_blocks)

    # the mixed system is symmetric indefinite with a zero (u1,u1) diagonal
    # block: CG/Jacobi are not applicable and BiCGStab breaks down on it.
    # The reference only ever runs this module through its dense sequential
    # backend (both inputs/*.arc use SequentialBasicLinearSystem); match
    # that until a MINRES backend lands.
    if config.solver.method != "dense":
        config.solver.method = "dense"

    system = prob.new_system(A, config.solver)
    with timer.phase("rhs-vector-assembly"):
        if config.f is not None:
            rhs = jnp.zeros(prob.n_dofs, dtype)
            system.rhs = prob.vector_source_rhs(rhs, (config.f, None))
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet(
                system, prob.group_dofs(bc.surface, comp=0), bc.value,
                bc.method, dtype_safe_penalty(bc.penalty, dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()
        x.block_until_ready()

    uv = prob.node_values(x)
    return BilaplacianResult(
        u1=uv[:, 0], u2=uv[:, 1],
        iterations=int(info["iterations"]),
        residual=float(info["residual"]), problem=prob,
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    bcs = BoundaryConditions()
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
                method=opt_text(
                    case.fem, "enforce-Dirichlet-method",
                    opt_text(d, "enforce-Dirichlet-method", "Penalty"),
                ),
            )
        )
    cfg = BilaplacianConfig(
        f=opt_float(case.fem, "f"),
        bcs=bcs,
        solver=case.solver,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Bilaplacian")(_run_arc)


_register()
