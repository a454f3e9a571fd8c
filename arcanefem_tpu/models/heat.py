"""Transient heat conduction: ∂T/∂t − λΔT = qdot, implicit Euler.

JAX rebuild of reference modules/heat: element matrix λS + M/dt
(FemModule.cc:679-770), convection boundary matrix h·(edge mass)
(FemModule.cc:629-673), per-step RHS with *lumped* T_old/dt
(FemModule.cc:487-493), convection flux h·Text·L/2 and Neumann flux, time
loop until t ≥ tmax (FemModule.cc:114-119).

Device-first inversion of the reference's loop: the matrix is assembled and
BC-finalized ONCE (the reference rebuilds it every step); each step only
rebuilds the RHS and re-runs the jit-cached PCG.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import jax.numpy as jnp
import numpy as np

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements
from ..solver.linear_system import SolverOptions, solve_finalized
from ..solver.iterative import make_precond


@dataclass
class ConvectionBC:
    surface: str
    h: float
    Text: float


@dataclass
class HeatConfig:
    lam: float = 1.0
    # constant source, or a manufactured source q(x, y, z, t) evaluated at
    # cell barycenters each step (the reference's manufactured-solution
    # machinery, ArcaneFemFunctions.h:1030-1053, extended in time)
    qdot: float | object | None = None
    Tinit: float = 0.0
    dt: float = 0.1
    tmax: float = 1.0
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    convection: list[ConvectionBC] = field(default_factory=list)
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4
    # "lumped" mirrors the reference's RHS (FemModule.cc:487-493: lumped
    # T_old/dt against a CONSISTENT M/dt in the LHS — an inconsistent mix
    # whose error grows as dt shrinks at fixed h).  "consistent" uses
    # M·T_old/dt and restores O(h²)+O(dt) convergence (MMS-tested).
    mass_rhs: str = "lumped"


@dataclass
class HeatResult:
    T: np.ndarray  # final temperature
    history: list  # [(t, T) snapshots] — empty unless keep_history
    steps: int
    problem: FemProblem
    flux: dict = None  # cell-type -> (nc, dim) heat flux −λ∇T
    # (the reference's post-processing-only Flux variable,
    # modules/heat/FemModule.cc:867-892)


def solve(mesh: Mesh, config: HeatConfig, dtype=np.float64,
          timer: PhaseTimer | None = None, keep_history: bool = False,
          T0: np.ndarray | None = None) -> HeatResult:
    """T0: optional restart temperature field (fem/checkpoint.py)."""
    timer = timer or PhaseTimer(verbose=False)
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=1, dtype=dtype)

    dt = config.dt
    with timer.phase("lhs-matrix-assembly"):
        A = prob.assemble_matrix(
            lambda ct, xyz: config.lam * elements.stiffness(ct, xyz)
            + elements.mass(ct, xyz) / dt
        )
        for cv in config.convection:
            A = prob.add_face_matrix(
                A, cv.surface,
                lambda ft, xyz, h=cv.h: h * elements.edge2_mass(xyz),
            )

    # freeze BCs into the matrix once (fem/transient.py)
    from ..fem.transient import anchor_atol, freeze_bcs

    system = prob.new_system(A, config.solver)
    for bc in config.bcs.dirichlet:
        pen = dtype_safe_penalty(bc.penalty, dtype)
        dofs = prob.group_dofs(bc.surface)
        prob.apply_dirichlet(system, dofs, bc.value, bc.method, pen)
    fbc = freeze_bcs(system)
    A_bc = fbc.A
    M = make_precond(A_bc, config.solver.preconditioner)

    # constant RHS pieces: neumann + convection h*Text (FemModule.cc:497-534)
    rhs_const = jnp.zeros(prob.n_dofs, dtype)
    for nm in config.bcs.neumann:
        if nm.value is not None:
            rhs_const = prob.neumann_rhs(rhs_const, nm.surface, value=nm.value)
    for cv in config.convection:
        rhs_const = prob.neumann_rhs(rhs_const, cv.surface, value=cv.h * cv.Text)
    qdot_fn = config.qdot if callable(config.qdot) else None
    if config.qdot is not None and qdot_fn is None:
        rhs_const = rhs_const + prob.constant_source_rhs(config.qdot)

    # time-independent source-quadrature data, hoisted out of the loop
    src_cells = []
    if qdot_fn is not None:
        for ct, conn in mesh.cells.items():
            xyz = prob.cell_xyz(ct)
            meas = elements.measure(ct, xyz)
            bc3 = jnp.mean(xyz, axis=1)  # (nc, dim)
            z = bc3[:, 2] if bc3.shape[1] > 2 else jnp.zeros_like(bc3[:, 0])
            npc = conn.shape[1]
            src_cells.append(
                (bc3[:, 0], bc3[:, 1], z, meas / npc, npc,
                 jnp.asarray(conn.reshape(-1)))
            )

    def _source_rhs_at(t_eval):
        """Manufactured source at barycenters: rhs[node] += q(bc, t)·meas/npc
        (applyManufacturedSourceToRhs, ArcaneFemFunctions.h:1030-1053)."""
        r = jnp.zeros(prob.n_dofs, dtype)
        for x, y, z, w, npc, dofs in src_cells:
            contrib = jnp.repeat(qdot_fn(x, y, z, t_eval) * w, npc)
            r = r.at[dofs].add(contrib)
        return r

    Mmat = None
    lumped = None
    if config.mass_rhs == "consistent":
        Mmat = prob.assemble_matrix(lambda ct, xyz: elements.mass(ct, xyz))
    elif config.mass_rhs == "lumped":
        # lumped nodal measure: rhs += T_old/dt * (sum of cell measure/npc)
        lnp = np.zeros(prob.n_dofs, np.float64)
        for ct, conn in mesh.cells.items():
            meas = np.asarray(elements.measure(ct, prob.cell_xyz(ct)))
            npc = conn.shape[1]
            np.add.at(lnp, conn.reshape(-1), np.repeat(meas / npc, npc))
        lumped = jnp.asarray(lnp.astype(dtype))
    else:
        raise ValueError(f"mass_rhs must be lumped|consistent, "
                         f"got {config.mass_rhs!r}")

    if T0 is not None:
        T = jnp.asarray(np.asarray(T0).reshape(-1).astype(dtype))
    else:
        T = jnp.full(prob.n_dofs, config.Tinit, dtype)
    t = 0.0
    steps = 0
    history = []
    with timer.phase("time-loop"):
        while t < config.tmax:
            old_mass = lumped * T if Mmat is None else Mmat.spmv(T)
            step_rhs = rhs_const + old_mass / dt
            if qdot_fn is not None:
                # implicit Euler: the source is taken at the NEW time level
                step_rhs = step_rhs + _source_rhs_at(t + dt)
            rhs = fbc.apply(step_rhs)
            x0 = fbc.warm_start(T)
            if steps == 0:
                # anchor later steps' absolute tolerance at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(
                    config.solver,
                    atol=max(config.solver.atol,
                             anchor_atol(A_bc, M, rhs, x0, config.solver.rtol,
                                         method=config.solver.method)),
                )
            T, info = solve_finalized(A_bc, rhs, opts, x0=x0, precond=M)
            t += dt
            steps += 1
            if keep_history:
                history.append((t, np.asarray(T)))

    Tf = prob.node_values(T)[:, 0]
    with timer.phase("update-variables"):
        flux = {}
        for ct, conn in mesh.cells.items():
            grads = elements.gradients(ct, prob.cell_xyz(ct))
            Tn = T[jnp.asarray(conn)]  # (nc, npc)
            flux[ct] = -config.lam * np.stack(
                [np.asarray(jnp.sum(g * Tn, axis=1)) for g in grads], axis=1
            )
    if config.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, Tf, config.result_file, config.result_epsilon
            )
    return HeatResult(
        T=Tf, history=history, steps=steps, problem=prob, flux=flux
    )


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None,
             keep_history: bool = False):
    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    bcs = BoundaryConditions()
    method = opt_text(case.fem, "enforce-Dirichlet-method", "Penalty")
    for d in case.fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                value=opt_float(d, "value", 0.0),
                method=opt_text(d, "enforce-Dirichlet-method", method),
                penalty=opt_float(case.fem, "penalty", 1.0e30),
            )
        )
    convection = [
        ConvectionBC(
            surface=opt_text(c, "surface"),
            h=opt_float(c, "h", 1.0),
            Text=opt_float(c, "Text", 0.0),
        )
        for c in case.fem.findall("convection-boundary-condition")
    ]
    cfg = HeatConfig(
        lam=opt_float(case.fem, "lambda", 1.0),
        qdot=opt_float(case.fem, "qdot"),
        Tinit=opt_float(case.fem, "Tinit", 0.0),
        dt=opt_float(case.fem, "dt", 0.1),
        tmax=opt_float(case.fem, "tmax", 1.0),
        bcs=bcs,
        convection=convection,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer,
                 keep_history=keep_history)


def _register():
    from ..fem.runner import register

    register("Heat")(_run_arc)


_register()
