"""Geometric multigrid preconditioner: transfer operators + CG iteration
counts (the BoomerAMG-PCG role, HypreDoFLinearSystem.cc:686-742)."""

import jax.numpy as jnp
import numpy as np

from arcanefem_tpu.mesh.structured import StructuredBox, apply_penalty_dirichlet
from arcanefem_tpu.solver.iterative import Precond, pcg
from arcanefem_tpu.solver.multigrid import (
    MGPrecond,
    _prolong_axis,
    _restrict_axis,
    build_mg,
    prolong3,
    restrict3,
)


def test_prolong_restrict_adjoint():
    """<P xc, xf> == <xc, R xf> (exact adjointness per axis and in 3D)."""
    rng = np.random.RandomState(0)
    cshape, fshape = (5, 4, 7), (9, 7, 13)
    xc = jnp.asarray(rng.rand(*cshape).reshape(-1))
    xf = jnp.asarray(rng.rand(*fshape).reshape(-1))
    lhs = float(jnp.vdot(prolong3(xc, cshape, fshape), xf))
    rhs = float(jnp.vdot(xc, restrict3(xf, fshape, cshape)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_prolong_exact_on_linear():
    """Trilinear interpolation reproduces linear fields exactly."""
    box = StructuredBox(8, 8, 8)
    c = box.grid_coords(np.float64)
    lin = lambda c3: 2.0 * c3[..., 0] - 3.0 * c3[..., 1] + 0.5 * c3[..., 2]
    coarse = lin(c[::2, ::2, ::2])
    fine = lin(c)
    got = prolong3(jnp.asarray(coarse.reshape(-1)), (5, 5, 5), (9, 9, 9))
    np.testing.assert_allclose(np.asarray(got), fine.reshape(-1), atol=1e-12)


import os
import pytest


@pytest.mark.skipif(
    not os.environ.get("AFEM_SLOW_TESTS"),
    reason="XLA:CPU compiles the V-cycle pathologically slowly (~8 min at "
    "8^3); run with AFEM_SLOW_TESTS=1. bench.py and chip_smoke.py exercise "
    "full MG-PCG on the GPU at 224^3.",
)
def test_mg_richardson_contracts():
    """A few M-preconditioned Richardson steps must slash the residual."""
    import jax

    box = StructuredBox(8, 8, 8)
    c3d = jnp.asarray(box.grid_coords(np.float64, jitter=0.1))
    A = box.assemble_stiffness(c3d)
    rhs = box.source_rhs(c3d, 1.0)
    mask = box.boundary_mask(("xmin", "xmax"))
    gv = np.zeros(box.n_nodes)
    gv[box.boundary_mask(("xmax",))] = 1.0
    P = 1e12
    A, rhs = apply_penalty_dirichlet(A, rhs, jnp.asarray(mask), jnp.asarray(gv), P)
    M = build_mg(box, c3d, mask, P, min_size=4)
    assert len(M.shapes) >= 2

    x = jnp.asarray(np.where(mask, gv, 0.0))
    free = ~np.asarray(mask)

    @jax.jit
    def step(x):
        r = rhs - A.spmv(x)
        return x + M.apply(r), r

    _, r0 = step(x)
    for _ in range(8):
        x, r = step(x)
    drop = np.abs(np.asarray(r)[free]).max() / np.abs(np.asarray(r0)[free]).max()
    assert drop < 1e-3, drop
