"""Linear elasticity: K u = f with traction/bodyforce/vector Dirichlet.

JAX rebuild of reference modules/elasticity (plane strain, 2 DoF per
node, FemModule.cc:100-117): λ, 2μ from E, ν (FemModule.cc:130-134), block-2
element matrices from the B^T D B form (FemModule.h:112-143 builds them from
outer products), bodyforce + traction RHS (FemModule.cc:221-272), all three
Dirichlet enforcement methods (FemModule.cc:285-400).  3D tetra (3 DoF)
blocks are also provided for the elastodynamics family.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions


@dataclass
class ElasticityConfig:
    E: float = 1.0
    nu: float = 0.3
    f: tuple = ()  # body force per component (None = absent)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-3  # reference epsilon (FemModule.cc:547)
    # noise floors for cross-solver comparison: the reference's 1e-16
    # (FemModule.cc:548) assumes identical roundoff; components more than
    # ~5 orders below the field scale are unconverged reference-solver
    # noise (verified against dense LU; see fem/validation.py)
    result_min_value: float = 1.0e-12
    result_min_value_rel: float = 2.0e-5


@dataclass
class ElasticityResult:
    u: np.ndarray  # (n_nodes, ndof)
    iterations: int
    residual: float
    problem: FemProblem


def lame(E: float, nu: float) -> tuple[float, float]:
    """(λ, 2μ) exactly as FemModule.cc:133-134."""
    mu2 = E / (2.0 * (1.0 + nu)) * 2.0
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu2


def element_blocks(cell_type: str, xyz, lam, mu2):
    if cell_type == "tria3":
        return elements.elasticity_tria3(xyz, lam, mu2)
    if cell_type == "tetra4":
        return elements.elasticity_tetra4(xyz, lam, mu2)
    raise ValueError(f"no elasticity kernel for '{cell_type}'")


def solve(
    mesh: Mesh,
    config: ElasticityConfig,
    dtype=np.float64,
    timer: PhaseTimer | None = None,
) -> ElasticityResult:
    from dataclasses import replace as _dc_replace

    timer = timer or PhaseTimer(verbose=False)
    # never mutate the CALLER's config: the method switch and the mesh-
    # sized rigid-body nullspace below must not leak into a reused config
    # (a stale nullspace from another mesh corrupts the AMG hierarchy)
    config = _dc_replace(config, solver=_dc_replace(config.solver))
    ndof = 3 if mesh.dim == 3 else 2

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype)

    lam, mu2 = lame(config.E, config.nu)
    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: element_blocks(ct, xyz, lam, mu2)
        )

    # RowElimination produces a nonsymmetric system; the reference selects
    # gmres/bicgstab in those case files (inputs/bar.2D.DirichletViaRow
    # Elimination.arc). Auto-upgrade if the case didn't.
    methods = {bc.method for bc in config.bcs.dirichlet} | {
        bc.method for bc in config.bcs.dirichlet_point
    }
    if "RowElimination" in methods and config.solver.method == "cg":
        config.solver.method = "bicgstab"

    if (config.solver.preconditioner == "amg"
            and config.solver.amg_nullspace is None):
        # rigid-body modes make the SA hierarchy see rotations (the classic
        # elasticity near-nullspace, solver/amg.py::rigid_body_modes)
        from ..solver.amg import rigid_body_modes

        config.solver.amg_nullspace = rigid_body_modes(mesh.coords, prob.ndof)

    system = prob.new_system(A, config.solver)

    with timer.phase("rhs-vector-assembly"):
        if config.f:
            system.rhs = prob.vector_source_rhs(system.rhs, config.f)
        for tr in config.bcs.traction:
            system.rhs = prob.traction_rhs(system.rhs, tr.surface, tr.t)
        for bc in config.bcs.dirichlet:
            prob.apply_dirichlet_vector(
                system, mesh.group_nodes(bc.surface), bc.values or (),
                bc.method, dtype_safe_penalty(bc.penalty, dtype),
            )
        for bc in config.bcs.dirichlet_point:
            prob.apply_dirichlet_vector(
                system, mesh.group_nodes(bc.node_group), bc.values or (),
                bc.method, dtype_safe_penalty(bc.penalty, dtype),
            )

    with timer.phase("solve-linear-system"):
        x, info = system.solve()
        x.block_until_ready()

    with timer.phase("update-variables"):
        u = prob.node_values(x)

    result = ElasticityResult(
        u=u,
        iterations=int(info["iterations"]),
        residual=float(info["residual"]),
        problem=prob,
    )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, config.result_file,
                config.result_epsilon, min_value=config.result_min_value,
                min_value_rel=config.result_min_value_rel,
            )
    return result


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    from ..fem.arc import opt_float, parse_bcs_vector, parse_null_vector

    cfg = ElasticityConfig(
        E=opt_float(case.fem, "E", 1.0),
        nu=opt_float(case.fem, "nu", 0.3),
        f=parse_null_vector(
            case.fem.findtext("f").strip() if case.fem.find("f") is not None else None
        ),
        bcs=parse_bcs_vector(case.fem),
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Elasticity")(_run_arc)


_register()
