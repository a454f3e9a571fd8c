"""Chebyshev polynomial preconditioner — the device stand-in for
Aleph's poly/ainv/ic/ilu/ilup preconditioner options
(AlephDoFLinearSystemFactory.axl:34-43).

Incomplete factorizations (ic/ilu/ilup) apply triangular solves, which are
inherently sequential and leave a wide device mostly idle; sparse
approximate inverses (ainv) need per-row least squares at setup.  The
standard accelerator substitute for all of them is a fixed-degree
polynomial in the Jacobi-scaled operator: every apply is `degree` SpMVs +
AXPYs (bandwidth-bound, jit-fusable) and the result
``M^{-1} = p(D^{-1}A) D^{-1}`` is symmetric in the D inner product, so it
is PCG-safe.

The polynomial is the shifted-and-scaled Chebyshev iteration on the
interval [lambda_max/eig_ratio, lambda_max] (Saad, "Iterative Methods",
Alg. 12.1, with Jacobi preconditioning folded in); lambda_max is estimated
by on-device power iteration at setup.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "inv_diag", "theta", "delta"],
    meta_fields=["degree"],
)
@dataclass
class ChebyshevPrecond:
    """apply(r) = p(D^{-1}A) D^{-1} r, p = degree-`degree` Chebyshev."""

    A: object  # BellMatrix or DiaMatrix (has .spmv)
    inv_diag: Array
    theta: Array  # (lmax+lmin)/2
    delta: Array  # (lmax-lmin)/2
    degree: int = 3

    def apply(self, r: Array) -> Array:
        sigma = self.theta / self.delta
        rho = 1.0 / sigma
        pr = self.inv_diag * r
        x = pr / self.theta
        d = x
        # fixed trip count -> unrolled at trace time, fused by XLA
        for _ in range(1, self.degree):
            res = pr - self.inv_diag * self.A.spmv(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / self.delta) * res
            x = x + d
            rho = rho_new
        return x


def build_chebyshev(
    A,
    degree: int = 3,
    eig_ratio: float = 30.0,
    power_iters: int = 12,
) -> ChebyshevPrecond:
    """Setup: Jacobi scaling + power-iteration lambda_max estimate.

    eig_ratio=30 covers the low end of the spectrum the way Hypre's
    polynomial smoothers do; the PCG outer iteration handles the rest.
    """
    d = A.diagonal()
    inv_diag = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)
    n = inv_diag.shape[0]
    v0 = jnp.asarray(
        np.random.RandomState(0).rand(n).astype(np.asarray(d).dtype)
    )

    @jax.jit
    def power(A, inv_diag, v):
        def step(v, _):
            w = inv_diag * A.spmv(v)
            return w / jnp.linalg.norm(w), None

        v, _ = jax.lax.scan(step, v, None, length=power_iters)
        w = inv_diag * A.spmv(v)
        return jnp.vdot(v, w) / jnp.vdot(v, v)

    lmax = 1.05 * power(A, inv_diag, v0)
    lmin = lmax / eig_ratio
    return ChebyshevPrecond(
        A=A,
        inv_diag=inv_diag,
        theta=(lmax + lmin) / 2.0,
        delta=(lmax - lmin) / 2.0,
        degree=degree,
    )
