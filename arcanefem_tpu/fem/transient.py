"""Frozen boundary conditions for transient loops.

The reference rebuilds matrix + BCs every time step (elastodynamics
FemModule.cc:144-158).  Device-first inversion: freeze the BC-modified matrix
once, and give each step's freshly built RHS the same treatment:

* penalty rows are overridden with P·g,
* Row/RowColumn-eliminated rows take their fixed value,
* the RowColumn correction (rhs_i -= A_ij·g_j, AlephDoFLinearSystem.cc:
  540-565) — captured once by finalizing against a zero RHS — is re-added.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..solver.linear_system import LinearSystem
from ..sparse.bell import BellMatrix


@dataclass
class FrozenBC:
    A: BellMatrix  # BC-finalized matrix
    pen_mask: jnp.ndarray
    pen_val: jnp.ndarray
    elim_mask: jnp.ndarray
    elim_rhs: jnp.ndarray
    rhs_corr: jnp.ndarray

    def apply(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Per-step RHS treatment (jit-safe)."""
        rhs = jnp.where(self.pen_mask, self.pen_val, rhs + self.rhs_corr)
        return jnp.where(self.elim_mask, self.elim_rhs, rhs)

    @property
    def dirichlet_values(self) -> jnp.ndarray:
        """g on constrained rows, 0 elsewhere (pen_val is P·g)."""
        d = self.A.diagonal()
        g_pen = jnp.where(
            self.pen_mask, self.pen_val / jnp.where(d == 0, 1.0, d), 0.0
        )
        return jnp.where(self.elim_mask, self.elim_rhs, g_pen)

    def warm_start(self, x: jnp.ndarray) -> jnp.ndarray:
        """Solver initial guess: the state with constrained rows snapped to
        their imposed values.  Without this, the first iterations' residual
        is dominated by penalty rows (scale P·|g−x|) and the relative
        convergence test fires before the interior equations are solved."""
        mask = self.pen_mask | self.elim_mask
        return jnp.where(mask, self.dirichlet_values, x)


def anchor_atol(
    A: BellMatrix, M, rhs, x0, rtol: float, method: str = "pcg"
) -> float:
    """Absolute tolerance anchored at a step's initial residual, measured in
    the norm the chosen solver monitors: ``rtol * ||b - A x0||_C`` for
    pcg/bicgstab (preconditioned norm) and ``rtol * ||b - A x0||_2`` for
    gmres (true-residual norm) — mixing the two can differ by orders of
    magnitude under a strong preconditioner.

    Transient loops warm-start every step, so the relative criterion
    (tol² = rtol²·rz0) degenerates when a late-time step is already
    converged: rz0 ≈ rounding noise, tol ≈ 0, and the solver burns its full
    iteration budget.  Threading this anchor (computed at the FIRST step)
    into later steps' ``SolverOptions.atol`` gives every step the same
    *absolute* accuracy as step one and lets converged steps exit at once.
    """
    r0 = rhs - A.spmv(x0)
    if method == "gmres":
        return float(rtol) * float(jnp.sqrt(jnp.abs(jnp.vdot(r0, r0))))
    z0 = M.apply(r0)
    return float(rtol) * float(jnp.sqrt(jnp.abs(jnp.vdot(r0, z0))))


def freeze_bcs(system: LinearSystem) -> FrozenBC:
    """Finalize a system whose rhs currently holds only BC-written values
    (penalty P·g rows); capture masks for per-step application."""
    A_bc, rhs_bc0 = system.finalized()
    n = A_bc.n_dofs
    elim_mask = np.zeros(n, bool)
    pen_mask = np.zeros(n, bool)
    for op in system.ops:
        if op.kind in ("row", "rowcol"):
            elim_mask[np.asarray(op.dofs)] = True
        else:
            pen_mask[np.asarray(op.dofs)] = True
    elim_j = jnp.asarray(elim_mask)
    pen_j = jnp.asarray(pen_mask)
    # rhs_bc0 on penalty rows = P·g (written by apply_dirichlet); on
    # eliminated rows = g; elsewhere = the RowColumn correction
    rhs_corr = jnp.where(elim_j | pen_j, 0.0, rhs_bc0)
    return FrozenBC(
        A=A_bc,
        pen_mask=pen_j,
        pen_val=jnp.where(pen_j, rhs_bc0, 0.0),
        elim_mask=elim_j,
        elim_rhs=jnp.where(elim_j, rhs_bc0, 0.0),
        rhs_corr=rhs_corr,
    )
