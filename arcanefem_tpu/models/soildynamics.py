"""Soil dynamics: seismic wave propagation with paraxial absorbing
boundaries and a double-couple source.

JAX rebuild of reference modules/soildynamics: Newmark-β scheme with
its own c0..c9 set (FemModule.cc:283-301; Generalized-alpha is declared WIP
and fatals there, :322), paraxial EDGE2 boundary terms with wave speeds
cp = √((λ+2μ)/ρ), cs = √(μ/ρ) (FemModule.cc:258-272) — LHS edge matrix
diag(c7(nx²cp+ny²cs), c7(ny²cp+nx²cs))·edge-mass and RHS
(c7·U − c8·V − c9·A) through the full directional matrix
P(n) = cp·n⊗n + cs·t⊗t (FemModule.cc:870-937) — transient tractions via
CaseTable, and the force-based double-couple source that *sets* RHS values
at the four source node groups (FemModule.cc:946-1000).

P(n) is quadratic in the normal, so face orientation is irrelevant.
Matrices are assembled and BC-frozen once; each step rebuilds only the RHS.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.casetable import CaseTable, read_case_table
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..fem.transient import anchor_atol, freeze_bcs
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import elements, geometry
from ..solver.linear_system import SolverOptions, solve_finalized
from ..solver.iterative import make_precond
from .elastodynamics import TractionTBC


@dataclass
class DoubleCouple:
    north: str
    south: str
    east: str
    west: str
    table: CaseTable
    method: str = "force-based"


@dataclass
class SoildynamicsConfig:
    tmax: float = 1.0
    dt: float = 0.1
    rho: float = 1.0
    lam: float | None = None
    mu: float | None = None
    E: float = 1.0
    nu: float = 0.3
    cp: float | None = None
    cs: float | None = None
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    tractions: list[TractionTBC] = field(default_factory=list)
    paraxial: list[str] = field(default_factory=list)  # surface names
    double_couple: DoubleCouple | None = None
    penalty: float = 1.0e30
    method: str = "Penalty"
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-3
    result_min_value_rel: float = 2.0e-5


@dataclass
class SoildynamicsResult:
    u: np.ndarray
    v: np.ndarray
    a: np.ndarray
    steps: int
    problem: FemProblem


def coefficients(cfg, lam, mu):
    """Newmark-β set, FemModule.cc:283-301."""
    dt, rho = cfg.dt, cfg.rho
    gamma = 0.5
    beta = 0.25 * (gamma + 0.5) ** 2
    return dict(
        c0=rho / (beta * dt * dt),
        c1=lam,
        c2=2 * mu,
        c3=rho / (beta * dt),
        c4=rho * (0.5 / beta - 1.0),
        c7=rho * gamma / beta / dt,
        c8=rho * (1.0 - gamma / beta),
        c9=rho * dt * (1.0 - gamma / (2.0 * beta)),
    ), gamma, beta


def solve(mesh: Mesh, cfg: SoildynamicsConfig, dtype=np.float64,
          timer: PhaseTimer | None = None) -> SoildynamicsResult:
    timer = timer or PhaseTimer(verbose=False)
    ndof = 2
    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype)

    # material resolution precedence exactly as FemModule.cc:261-278:
    # E/nu -> λ,μ,cs,cp; explicit λ,μ -> cs,cp; explicit cp,cs -> λ,μ
    mu = cfg.E / (2 * (1 + cfg.nu))
    lam = cfg.E * cfg.nu / ((1 + cfg.nu) * (1 - 2 * cfg.nu))
    if cfg.mu is not None and cfg.lam is not None:
        mu, lam = cfg.mu, cfg.lam
    cs = float(np.sqrt(mu / cfg.rho))
    cp = float(np.sqrt((lam + 2 * mu) / cfg.rho))
    if cfg.cp is not None and cfg.cs is not None:
        cp, cs = cfg.cp, cfg.cs
        mu = cs * cs * cfg.rho
        lam = cp * cp * cfg.rho - 2 * mu
    c, gamma, beta = coefficients(cfg, lam, mu)
    dt = cfg.dt

    with timer.phase("lhs-matrix-assembly"):
        Mm = prob.assemble_matrix(lambda ct, xyz: elements.mass_blocks(ct, xyz, ndof))
        Dm = prob.assemble_matrix(lambda ct, xyz: elements.divdiv(ct, xyz))
        Em = prob.assemble_matrix(lambda ct, xyz: elements.epseps(ct, xyz))
        A = Mm.with_values(
            c["c0"] * Mm.values + c["c1"] * Dm.values + c["c2"] * Em.values
        )
        # paraxial LHS edge blocks (FemModule.cc EDGE2 matrix):
        # diag(c7(nx²cp+ny²cs), c7(ny²cp+nx²cs)) × edge mass
        for surf in cfg.paraxial:
            def edge_blocks(ft, xyz):
                em = elements.edge2_mass(xyz)  # (nf, 2, 2)
                n = geometry.edge2_normal(xyz)  # (nf, 2)
                dxx = c["c7"] * (n[:, 0] ** 2 * cp + n[:, 1] ** 2 * cs)
                dyy = c["c7"] * (n[:, 1] ** 2 * cp + n[:, 0] ** 2 * cs)
                diag = jnp.stack([dxx, dyy], axis=-1)  # (nf, 2)
                eye = jnp.eye(2, dtype=xyz.dtype)
                blk = em[:, :, :, None, None] * (
                    diag[:, None, None, :, None] * eye[None, None, None]
                )
                return blk

            A = prob.add_face_matrix(A, surf, edge_blocks)

    # Dirichlet (u1/u2 style) frozen once
    pen = dtype_safe_penalty(cfg.penalty, dtype)
    system = prob.new_system(A, cfg.solver)
    dir_mask = np.zeros(prob.n_dofs, bool)
    dir_gval = np.zeros(prob.n_dofs, np.float64)
    for bc in cfg.bcs.dirichlet:
        nodes = mesh.group_nodes(bc.surface)
        for comp, v in enumerate(bc.values or ()):
            if v is None or comp >= ndof:
                continue
            dofs = prob.dof_ids(nodes, comp)
            prob.apply_dirichlet(system, dofs, v, bc.method or cfg.method, pen)
            dir_mask[dofs] = True
            dir_gval[dofs] = v
    fbc = freeze_bcs(system)
    ns = None
    if cfg.solver.preconditioner == "amg":
        from ..solver.amg import rigid_body_modes

        ns = rigid_body_modes(mesh.coords, ndof)
    M_pre = make_precond(fbc.A, cfg.solver.preconditioner, nullspace=ns)

    # constant tractions; timed ones interpolated per step
    const_tr = jnp.zeros(prob.n_dofs, dtype)
    timed_tr = []
    for tr in cfg.tractions:
        if tr.table is not None:
            timed_tr.append(tr)
        elif any(v is not None for v in tr.t):
            const_tr = prob.traction_rhs(const_tr, tr.surface, tr.t)

    # paraxial RHS data per group
    parax = []
    for surf in cfg.paraxial:
        for ft, conn in mesh.face_groups[surf].items():
            xyz = prob.face_xyz(conn)
            L = geometry.edge2_length(xyz)
            n = np.asarray(geometry.edge2_normal(xyz))
            nx, ny = n[:, 0], n[:, 1]
            P = np.zeros((len(conn), 2, 2))
            P[:, 0, 0] = cp * nx * nx + cs * ny * ny
            P[:, 0, 1] = (cp - cs) * nx * ny
            P[:, 1, 0] = (cp - cs) * nx * ny
            P[:, 1, 1] = cp * ny * ny + cs * nx * nx
            parax.append(
                (jnp.asarray(conn), jnp.asarray(np.asarray(L) / 6.0),
                 jnp.asarray(P.astype(np.float64)))
            )

    # double-couple dof indices
    dc = cfg.double_couple
    if dc is not None:
        dc_pos = jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.north), 0))
        dc_neg = jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.south), 0))
        dc_east = jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.east), 1))
        dc_west = jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.west), 1))

    @jax.jit
    def step_rhs(U, V, Acc, rhs_t, dc_force):
        rhs = const_tr + rhs_t
        rhs = rhs + Mm.spmv(c["c0"] * U + c["c3"] * V + c["c4"] * Acc)
        # paraxial: (c7 U − c8 V − c9 A) through P(n), edge-mass weighted
        X = (c["c7"] * U - c["c8"] * V - c["c9"] * Acc).reshape(-1, 2)
        for conn, L6, P in parax:
            xf = X[conn]  # (nf, 2, 2comp)
            s = jnp.sum(xf, axis=1, keepdims=True)  # (nf, 1, 2)
            contrib = jnp.einsum(
                "fab,fib->fia", P, (s + xf)
            ) * L6[:, None, None]
            rhs = rhs.reshape(-1, 2).at[conn].add(contrib).reshape(-1)
        rhs = fbc.apply(rhs)
        if dc is not None:
            rhs = rhs.at[dc_pos].set(dc_force)
            rhs = rhs.at[dc_neg].set(-dc_force)
            rhs = rhs.at[dc_east].set(-dc_force)
            rhs = rhs.at[dc_west].set(dc_force)
        return rhs

    @jax.jit
    def newmark_update(dU, U, V, Acc):
        aloc = (dU - U - dt * V) / (beta * dt * dt) - (1 - 2 * beta) / (2 * beta) * Acc
        Vn = V + dt * ((1 - gamma) * Acc + gamma * aloc)
        return dU, Vn, aloc

    U = jnp.asarray(np.where(dir_mask, dir_gval, 0.0).astype(dtype))
    V = jnp.zeros(prob.n_dofs, dtype)
    Acc = jnp.zeros(prob.n_dofs, dtype)

    t = dt
    steps = 0
    with timer.phase("time-loop"):
        while t < cfg.tmax + 1e-12 * dt:
            rhs_t = jnp.zeros(prob.n_dofs, dtype)
            for tr in timed_tr:
                vec = np.asarray(tr.table.value(t))
                rhs_t = prob.traction_rhs(
                    rhs_t, tr.surface, tuple(float(x) for x in vec[:ndof])
                )
            dcf = float(dc.table.value(t)[0]) if dc is not None else 0.0
            rhs = step_rhs(U, V, Acc, rhs_t, dcf)
            x0 = fbc.warm_start(U)
            if steps == 0:
                # anchor later steps' absolute tolerance at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(
                    cfg.solver,
                    atol=max(cfg.solver.atol,
                             anchor_atol(fbc.A, M_pre, rhs, x0, cfg.solver.rtol,
                                         method=cfg.solver.method)),
                )
            dU, info = solve_finalized(fbc.A, rhs, opts, x0=x0, precond=M_pre)
            U, V, Acc = newmark_update(dU, U, V, Acc)
            t += dt
            steps += 1

    u = prob.node_values(U)
    res = SoildynamicsResult(
        u=u, v=prob.node_values(V), a=prob.node_values(Acc),
        steps=steps, problem=prob,
    )
    if cfg.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, cfg.result_file, cfg.result_epsilon,
                min_value_rel=cfg.result_min_value_rel,
            )
    return res


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    import os

    from ..fem.arc import opt_float, opt_text
    from ..fem.bcs import DirichletBC

    fem = case.fem
    bcs = BoundaryConditions()
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    for d in fem.findall("dirichlet-boundary-condition"):
        bcs.dirichlet.append(
            DirichletBC(
                surface=opt_text(d, "surface"),
                values=(opt_float(d, "u1"), opt_float(d, "u2")),
                method=method,
            )
        )
    tractions = []
    for tr in fem.findall("traction-boundary-condition"):
        fn = opt_text(tr, "traction-input-file")
        table = read_case_table(os.path.join(case.base_dir, fn), 3) if fn else None
        tractions.append(
            TractionTBC(
                surface=opt_text(tr, "surface"),
                t=(opt_float(tr, "t1"), opt_float(tr, "t2")),
                input_file=fn,
                table=table,
            )
        )
    paraxial = [
        opt_text(p, "surface") for p in fem.findall("paraxial-boundary-condition")
    ]
    dc = None
    dce = fem.find("double-couple")
    if dce is not None:
        dc = DoubleCouple(
            north=opt_text(dce, "north-node-name"),
            south=opt_text(dce, "south-node-name"),
            east=opt_text(dce, "east-node-name"),
            west=opt_text(dce, "west-node-name"),
            table=read_case_table(
                os.path.join(case.base_dir, opt_text(dce, "double-couple-input-file")),
                1,
            ),
            method=opt_text(dce, "method", "force-based"),
        )
    cfg = SoildynamicsConfig(
        tmax=opt_float(fem, "tmax", 1.0),
        dt=opt_float(fem, "dt", 0.1),
        rho=opt_float(fem, "rho", 1.0),
        lam=opt_float(fem, "lambda"),
        mu=opt_float(fem, "mu"),
        E=opt_float(fem, "E", 1.0),
        nu=opt_float(fem, "nu", 0.3),
        cp=opt_float(fem, "cp"),
        cs=opt_float(fem, "cs"),
        bcs=bcs,
        tractions=tractions,
        paraxial=paraxial,
        double_couple=dc,
        penalty=opt_float(fem, "penalty", 1.0e30),
        method=method,
        solver=case.solver,
        result_file=case.result_file if check else None,
    )
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Soildynamics")(_run_arc)


_register()
