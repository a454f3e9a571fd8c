"""Geometric multigrid preconditioner for structured-box problems.

The structured-box counterpart of the reference's BoomerAMG-preconditioned PCG
(femutils/HypreDoFLinearSystem.cc:686-742: 1 V-cycle of AMG per CG
iteration).  On a structured Kuhn-tet box every multigrid ingredient is a
regular stencil operation — damped-Jacobi smoothing, trilinear
prolongation/full-weighting restriction via per-axis reshape/concat (no
scatter, no gather), and rediscretized coarse operators assembled with the
same stencil assembly — so the whole V-cycle is bandwidth-bound streaming.

Where BoomerAMG builds its hierarchy from the matrix graph (PMIS coarsening,
HypreDoFLinearSystem.cc:698-723), the structured hierarchy is geometric:
coarsen the node grid 2× per axis and re-assemble on the coarsened
coordinates (asymptotically Galerkin for nested P1 spaces).

Dirichlet penalty rows are handled by masking: the V-cycle acts on the
free-DoF residual; penalty rows get the exact Jacobi action 1/P.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.structured import StructuredBox
from ..sparse.dia import DiaMatrix


# --- per-axis transfer kernels (regular reshape/concat, no scatter) --------

def _sl(a, axis, sl):
    """a[..., sl, ...] with the slice on `axis` (no transposition)."""
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return a[tuple(idx)]


def _prolong_axis(c: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1D linear interpolation along `axis`: (n+1) -> (2n+1).

    Implemented with stack+reshape on the axis itself — a moveaxis-based
    version forces physical transposes of the full grid per axis, which
    dominates V-cycle time at 10M+ DoF.
    """
    lo = _sl(c, axis, slice(None, -1))
    hi = _sl(c, axis, slice(1, None))
    mid = 0.5 * (lo + hi)
    body = jnp.stack([lo, mid], axis=axis + 1)
    new_shape = c.shape[:axis] + (2 * (c.shape[axis] - 1),) + c.shape[axis + 1:]
    body = body.reshape(new_shape)
    return jnp.concatenate([body, _sl(c, axis, slice(-1, None))], axis=axis)


def _restrict_axis(f: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Adjoint of _prolong_axis: out[i] = f[2i] + 0.5(f[2i-1] + f[2i+1])."""
    even = _sl(f, axis, slice(None, None, 2))
    odd = _sl(f, axis, slice(1, None, 2))
    zeros = jnp.zeros_like(_sl(odd, axis, slice(0, 1)))
    return even + 0.5 * (
        jnp.concatenate([zeros, odd], axis=axis)
        + jnp.concatenate([odd, zeros], axis=axis)
    )


def prolong3(xc: jnp.ndarray, cshape, fshape) -> jnp.ndarray:
    x = xc.reshape(cshape)
    for ax in range(3):
        x = _prolong_axis(x, ax)
    return x.reshape(-1)


def restrict3(xf: jnp.ndarray, fshape, cshape) -> jnp.ndarray:
    x = xf.reshape(fshape)
    for ax in range(3):
        x = _restrict_axis(x, ax)
    return x.reshape(-1)


# --- the preconditioner pytree ---------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=["mats", "inv_diags", "masks"],
    meta_fields=["shapes", "nu", "omega", "coarse_iters"],
)
@dataclass
class MGPrecond:
    """V-cycle preconditioner.

    mats: per-level penalized DiaMatrix operators.
    """

    mats: tuple
    inv_diags: tuple  # per level (N,)
    masks: tuple  # per level (N,) bool Dirichlet mask
    shapes: tuple  # per level (nx+1, ny+1, nz+1)
    nu: int = 2
    omega: float = 0.8

    coarse_iters: int = 40

    def _smooth(self, l: int, x, b, sweeps: int):
        A, d = self.mats[l], self.inv_diags[l]
        om = jnp.asarray(self.omega, b.dtype)
        for _ in range(sweeps):
            x = x + om * d * (b - A.spmv(x))
        return x

    def _vcycle(self, l: int, b):
        if l == len(self.mats) - 1:
            x = jnp.zeros_like(b)
            return self._smooth(l, x, b, self.coarse_iters)
        x = self._smooth(l, jnp.zeros_like(b), b, self.nu)
        r = b - self.mats[l].spmv(x)
        r = jnp.where(self.masks[l], 0.0, r)
        rc = restrict3(r, self.shapes[l], self.shapes[l + 1])
        rc = jnp.where(self.masks[l + 1], 0.0, rc)
        xc = self._vcycle(l + 1, rc)
        xc = jnp.where(self.masks[l + 1], 0.0, xc)
        x = x + prolong3(xc, self.shapes[l + 1], self.shapes[l])
        return self._smooth(l, x, b, self.nu)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        """M⁻¹ r: V-cycle on free rows + exact Jacobi on penalty rows."""
        rz = jnp.where(self.masks[0], 0.0, r)
        z = self._vcycle(0, rz)
        return jnp.where(self.masks[0], r * self.inv_diags[0], z)


def build_mg(
    box: StructuredBox,
    coords3d: jnp.ndarray,
    dirichlet_mask: np.ndarray,
    penalty: float,
    bc_planes: tuple = ("xmin", "xmax"),
    min_size: int = 8,
    nu: int = 2,
    omega: float = 0.8,
) -> MGPrecond:
    """Build the hierarchy: coarsen the grid 2x per axis while divisible.

    dirichlet_mask: fine-level (n_nodes,) bool of penalty rows; coarse masks
    are the same box planes on the coarse grids.
    """
    dtype = coords3d.dtype
    mats, inv_diags, masks, shapes = [], [], [], []
    b, c3, mask = box, coords3d, np.asarray(dirichlet_mask)
    while True:
        A = b.assemble_stiffness(c3)
        d0 = A.offsets.index(0)
        pen = jnp.where(jnp.asarray(mask), jnp.asarray(penalty, dtype), A.bands[d0])
        Ab = A.bands.at[d0].set(pen)
        d = Ab[d0]
        mats.append(DiaMatrix(bands=Ab, offsets=A.offsets))
        inv_diags.append(jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0))
        masks.append(jnp.asarray(mask))
        shapes.append((b.nx + 1, b.ny + 1, b.nz + 1))
        if (
            b.nx % 2 or b.ny % 2 or b.nz % 2
            or min(b.nx, b.ny, b.nz) // 2 < min_size
        ):
            break
        b = StructuredBox(b.nx // 2, b.ny // 2, b.nz // 2, b.lx, b.ly, b.lz)
        c3 = c3.reshape(shapes[-1] + (3,))[::2, ::2, ::2]
        mask = b.boundary_mask(bc_planes)
    return MGPrecond(
        mats=tuple(mats),
        inv_diags=tuple(inv_diags),
        masks=tuple(masks),
        shapes=tuple(shapes),
        nu=nu,
        omega=omega,
    )
