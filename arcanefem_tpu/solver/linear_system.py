"""Linear-system facade with deferred boundary-condition semantics.

Device counterpart of the reference's ``DoFLinearSystem``
(femutils/DoFLinearSystem.h:126-286) and its backends.  The deferred
semantics are preserved exactly:

* ``set_forced(dofs, values)``     == matrixSetValue on the diagonal:
  overrides any accumulated adds at solve time (DoFLinearSystem.h:157-170,
  applied in HypreDoFLinearSystem.cc:356-382 `_applyForcedValuesToLhs`).
  Used by the penalty Dirichlet method.
* ``eliminate_row(dofs, values)``  == ELIMINATE_ROW: row := e_i, rhs := g
  (AlephDoFLinearSystem.cc:501-538).
* ``eliminate_row_col(dofs, values)`` == ELIMINATE_ROW_COLUMN: additionally
  rhs_i -= A[i,j] * g_j for every untouched row i, column j zeroed
  (AlephDoFLinearSystem.cc:540-583).

Everything is applied as masked vector kernels over the BELL layout inside
one jitted ``finalize`` step — the GPU-kernel role of
HypreDoFLinearSystem.cc:319-382.

Solver backends (selected by name, mirroring the reference's
IDoFLinearSystemFactory services):
* "dense"     — dense direct solve (the SequentialBasicLinearSystem role,
                DoFLinearSystem.cc:106-152; tiny systems/tests)
* "cg"        — Jacobi/block-Jacobi preconditioned conjugate gradients
                (the Hypre BoomerAMG-PCG role, HypreDoFLinearSystem.cc:686-742)
* "bicgstab"  — for the nonsymmetric systems (aerodynamics farfield rows,
                row-elimination-asymmetric matrices)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.bell import BellMatrix
from .iterative import bicgstab, gmres, make_precond, pcg


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dofs", "values"],
    meta_fields=["kind"],
)
@dataclass
class BCOp:
    """One deferred boundary-condition operation.

    kind: 'forced' | 'row' | 'rowcol'; dofs int32 (k,), values (k,).
    dofs are scalar-dof ids (node * block + component).
    """

    dofs: jnp.ndarray
    values: jnp.ndarray
    kind: str


def _dof_masks(n_dofs: int, ops: list[BCOp], kinds: tuple[str, ...]):
    # result dtype promotes only over the ops actually being masked, so a
    # f32 forced op cannot promote row-elimination masks of a f64 system
    sel = [o for o in ops if o.kind in kinds]
    mask = jnp.zeros(n_dofs, bool)
    val = (
        jnp.zeros(n_dofs, jnp.result_type(*[o.values.dtype for o in sel]))
        if sel
        else jnp.zeros(n_dofs)
    )
    for op in sel:
        mask = mask.at[op.dofs].set(True)
        val = val.at[op.dofs].set(op.values.astype(val.dtype))
    return mask, val


def apply_bcs(
    A: BellMatrix,
    rhs: jnp.ndarray,
    ops: list[BCOp],
    penalty: jnp.ndarray | float | None = None,
) -> tuple[BellMatrix, jnp.ndarray]:
    """Produce the (A, b) actually handed to the solver. Jit-safe.

    `forced` ops need per-op penalty scaling of the rhs done by the caller
    (the reference writes rhs = P*g at BC-application time); here `values`
    of a forced op is the final diagonal value and rhs is assumed already
    set by the caller — matching the reference split where BC functions
    write the rhs and DoFLinearSystem holds the forced matrix values.
    """
    n = A.n_dofs
    b = A.block
    N, W = A.topo.n_nodes, A.topo.width
    vals = A.values  # (N, W, b, b)
    dtype = vals.dtype

    forced_mask, forced_val = _dof_masks(n, ops, ("forced",))
    row_mask, row_val = _dof_masks(n, ops, ("row",))
    rc_mask, rc_val = _dof_masks(n, ops, ("rowcol",))

    any_forced = any(o.kind == "forced" for o in ops)
    any_row = any(o.kind == "row" for o in ops)
    any_rc = any(o.kind == "rowcol" for o in ops)

    diag_slot = jnp.asarray(A.topo.diag_slot)  # (N,)
    cols = jnp.asarray(A.topo.ell_cols)  # (N, W)

    # --- row/column elimination -------------------------------------------
    if any_rc:
        # rhs_i -= A[i,j] * g_j over eliminated columns j (gather-based, the
        # kernel form of AlephDoFLinearSystem.cc:540-565)
        g = jnp.where(rc_mask, rc_val.astype(dtype), 0.0)
        contrib = A.spmv(g)
        rhs = rhs - jnp.where(rc_mask, 0.0, contrib)

    elim_mask = row_mask | rc_mask  # rows to clear
    elim_val = jnp.where(rc_mask, rc_val, row_val)

    if any_row or any_rc:
        rmask = elim_mask.reshape(N, 1, b, 1)
        vals = jnp.where(rmask, jnp.zeros_like(vals), vals)
        if any_rc:
            cmask_dof = rc_mask.reshape(N, b)[cols]  # (N, W, b)
            vals = jnp.where(cmask_dof[:, :, None, :], jnp.zeros_like(vals), vals)
        # diag := 1 on eliminated rows
        flat = vals.reshape(N * W, b, b)
        eye = jnp.eye(b, dtype=dtype)
        dblk = flat[diag_slot]
        emask_n = elim_mask.reshape(N, b)
        new_diag = jnp.where(
            emask_n[:, :, None], eye[None, :, :], dblk
        )
        flat = flat.at[diag_slot].set(new_diag)
        vals = flat.reshape(N, W, b, b)
        rhs = jnp.where(elim_mask, elim_val.astype(rhs.dtype), rhs)

    # --- forced (penalty) values -------------------------------------------
    if any_forced:
        flat = vals.reshape(N * W, b, b)
        dblk = flat[diag_slot]
        fmask_n = forced_mask.reshape(N, b)
        fval_n = forced_val.reshape(N, b).astype(dtype)
        # only the scalar diagonal entry (a,a) is forced
        eyeb = jnp.eye(b, dtype=bool)[None]
        mask2 = fmask_n[:, :, None] & eyeb
        new_diag = jnp.where(mask2, fval_n[:, :, None] * jnp.eye(b, dtype=dtype)[None], dblk)
        flat = flat.at[diag_slot].set(new_diag)
        vals = flat.reshape(N, W, b, b)

    return A.with_values(vals), rhs


@dataclass
class SolverOptions:
    """Mirrors HypreDoFLinearSystemFactory.axl:4-13 defaults."""

    method: str = "cg"  # cg | bicgstab | gmres | dense
    rtol: float = 1.0e-7
    atol: float = 0.0
    max_iter: int = 1000
    gmres_restart: int = 30  # Krylov basis size for method="gmres"
    preconditioner: str = "jacobi"  # none | jacobi | block-jacobi
    precise_dot: bool = True  # compensated f32 dots (no-op for f64)
    # optional (n_dofs, m) near-nullspace handed to the AMG setup — rigid
    # body modes for elasticity-family block systems
    # (solver/amg.py::rigid_body_modes); ignored by other preconditioners
    amg_nullspace: object = None
    # what to do when the iterative solve exhausts max_iter above rtol
    # (the Aleph stop_error_strategy role, AlephDoFLinearSystem.cc:360-362):
    # "dump" writes SolveErrorMatrix.npz + warns, "raise" additionally
    # raises, "ignore" skips the host-side check (keeps transient loops
    # free of per-step device syncs)
    fail_action: str = "dump"


@dataclass
class LinearSystem:
    """Mutable facade used by the physics modules (DoFLinearSystem role)."""

    matrix: BellMatrix
    rhs: jnp.ndarray
    ops: list[BCOp] = field(default_factory=list)
    options: SolverOptions = field(default_factory=SolverOptions)
    # Dirichlet (dofs, values) pairs for warm-starting the Krylov solve so
    # penalty-scaled rows start with zero error (see iterative.pcg docstring)
    guesses: list[tuple[np.ndarray, jnp.ndarray]] = field(default_factory=list)

    def add_guess(self, dofs, values) -> None:
        self.guesses.append((np.asarray(dofs), jnp.asarray(values)))

    def initial_guess(self, x0: jnp.ndarray | None = None) -> jnp.ndarray:
        x = x0 if x0 is not None else jnp.zeros_like(self.rhs)
        for dofs, vals in self.guesses:
            x = x.at[jnp.asarray(dofs)].set(vals.astype(x.dtype))
        return x

    # -- BC entry points (deferred) -----------------------------------------
    def set_forced_diag(self, dofs: np.ndarray, values: jnp.ndarray) -> None:
        self.ops.append(BCOp(jnp.asarray(dofs), jnp.asarray(values), "forced"))

    def eliminate_row(self, dofs: np.ndarray, values: jnp.ndarray) -> None:
        self.ops.append(BCOp(jnp.asarray(dofs), jnp.asarray(values), "row"))

    def eliminate_row_col(self, dofs: np.ndarray, values: jnp.ndarray) -> None:
        self.ops.append(BCOp(jnp.asarray(dofs), jnp.asarray(values), "rowcol"))

    def set_rhs(self, dofs, values) -> None:
        self.rhs = self.rhs.at[jnp.asarray(dofs)].set(jnp.asarray(values, dtype=self.rhs.dtype))

    def add_rhs(self, dofs, values) -> None:
        self.rhs = self.rhs.at[jnp.asarray(dofs)].add(jnp.asarray(values, dtype=self.rhs.dtype))

    # -- solve ----------------------------------------------------------------
    def finalized(self) -> tuple[BellMatrix, jnp.ndarray]:
        return apply_bcs(self.matrix, self.rhs, self.ops)

    def solve(self, x0: jnp.ndarray | None = None):
        A, b = self.finalized()
        return solve_finalized(A, b, self.options, self.initial_guess(x0))


def solve_finalized(
    A: BellMatrix,
    b: jnp.ndarray,
    options: SolverOptions,
    x0: jnp.ndarray | None = None,
    precond=None,
):
    """Dispatch on backend. Returns (x, info dict)."""
    if options.method == "dense":
        dense = A.todense()
        x = jnp.linalg.solve(dense, b)
        return x, {"iterations": 1, "residual": 0.0}

    M = precond if precond is not None else make_precond(
        A, options.preconditioner, nullspace=options.amg_nullspace
    )
    if x0 is None:
        x0 = jnp.zeros_like(b)
    use_precise = options.precise_dot and b.dtype == jnp.float32
    if options.method == "cg":
        x, iters, res = pcg(
            A, b, M, x0, options.rtol, options.atol, options.max_iter,
            use_precise_dot=use_precise,
        )
    elif options.method == "bicgstab":
        x, iters, res = bicgstab(
            A, b, M, x0, options.rtol, options.atol, options.max_iter,
            use_precise_dot=use_precise,
        )
    elif options.method == "bicgstab2":
        from .iterative import bicgstab2

        x, iters, res = bicgstab2(
            A, b, M, x0, options.rtol, options.atol, options.max_iter,
            use_precise_dot=use_precise,
        )
    elif options.method == "gmres":
        x, iters, res = gmres(
            A, b, M, x0, options.rtol, options.atol, options.max_iter,
            restart=options.gmres_restart, use_precise_dot=use_precise,
        )
    else:
        raise ValueError(f"unknown solver method '{options.method}'")

    # True-residual report (Hypre reports/monitors ||b-Ax||/||b|| for cold
    # solves; our Krylov methods monitor the preconditioned norm — see the
    # pcg docstring).  One extra SpMV per solve makes the golden-path
    # convergence quality directly comparable to the reference's rtol
    # semantics (HypreDoFLinearSystemFactory.axl:4-13).
    bn = jnp.linalg.norm(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                         else b)
    true_res = jnp.linalg.norm(b - A.spmv(x)) / jnp.where(bn > 0.0, bn, 1.0)
    info = {"iterations": iters, "residual": res, "true_residual": true_res}

    if options.fail_action != "ignore":
        # non-convergence diagnostics (the Aleph stop_error_strategy role:
        # dump the system to SolveErrorAlephMatrix.dbg,
        # AlephDoFLinearSystem.cc:360-362).  Costs one host scalar fetch.
        it_h, res_h = int(iters), float(res)
        if it_h >= options.max_iter and res_h > options.rtol:
            path = _dump_solve_failure(A, b, x0, options, info)
            import warnings

            warnings.warn(
                f"solver '{options.method}' did NOT converge: "
                f"{it_h} iters, monitored rel residual {res_h:.3e} "
                f"(true ||b-Ax||/||b|| {float(true_res):.3e})"
                + (f"; system dumped to {path}" if path else ""),
                stacklevel=2,
            )
            if options.fail_action == "raise":
                raise RuntimeError(
                    f"linear solve failed to converge ({it_h} iters, "
                    f"rel residual {res_h:.3e} > rtol {options.rtol:g})"
                )
    return x, info


def _dump_solve_failure(A, b, x0, options, info) -> str | None:
    """Write the failed system as an npz artifact (BELL values + columns +
    rhs + guess), mirroring Aleph's SolveErrorAlephMatrix.dbg dump.  Best
    effort — never raises."""
    import os

    try:
        path = os.path.join(
            os.environ.get("AFEM_SOLVE_DEBUG_DIR", "."),
            "SolveErrorMatrix.npz",
        )
        payload = {
            "rhs": np.asarray(b),
            "x0": np.asarray(x0),
            "method": np.str_(options.method),
            "preconditioner": np.str_(options.preconditioner),
            "rtol": np.float64(options.rtol),
            "iterations": np.int64(int(info["iterations"])),
            "residual": np.float64(float(info["residual"])),
        }
        topo = getattr(A, "topo", None)
        vals = getattr(A, "values", None)
        if topo is not None and vals is not None:
            payload["bell_values"] = np.asarray(vals)
            payload["ell_cols"] = np.asarray(topo.ell_cols)
        np.savez_compressed(path, **payload)
        return path
    except Exception:
        return None
