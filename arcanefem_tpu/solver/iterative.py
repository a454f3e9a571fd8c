"""Iterative Krylov solvers (jit-compiled, static shapes, lax.while_loop).

These fill the role of the reference's distributed solver backends:
Hypre ParCSR PCG (HypreDoFLinearSystem.cc:686-742, rtol 1e-7 / max 1000
defaults from HypreDoFLinearSystemFactory.axl:4-13) and Aleph PCG/BiCGStab
(AlephDoFLinearSystem.cc:344-379).  The SpMV is the BELL gather kernel; dot
products are single `jnp.vdot`s that become `psum`s under shard_map.

The matrix and preconditioner are JAX pytrees (values traced, topology
static), so repeated solves with the same mesh hit the jit cache.

Precision: solves run in f32 or f64 (the GPU has native fp64).  In f32 the
dot products can use compensated (double-float) accumulation to reach
tight residuals — see ``precise_dot``.  Matrix contractions run at
the HIGHEST matmul precision that ``utils/device.setup`` pins.  Tests run
f64 on CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..sparse.bell import BellMatrix

Array = jnp.ndarray


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["kind"],
)
@dataclass
class Precond:
    """Preconditioner as a pytree: kind in {none, jacobi, block-jacobi}."""

    data: tuple
    kind: str

    def apply(self, r: Array) -> Array:
        if self.kind == "none":
            return r
        if self.kind == "jacobi":
            (inv_diag,) = self.data
            return inv_diag * r
        if self.kind == "block-jacobi":
            (inv_blocks,) = self.data  # (N, b, b)
            n, b, _ = inv_blocks.shape
            rn = r.reshape(n, b)
            return jnp.einsum("nab,nb->na", inv_blocks, rn).reshape(-1)
        raise ValueError(f"unknown preconditioner kind '{self.kind}'")


def make_precond(
    A: BellMatrix, name: str | None, nullspace=None
) -> "Precond | AMGPrecond":
    """Build a preconditioner; the 'amg' branch returns an AMGPrecond
    (solver/amg.py) — both expose the same ``.apply(r)`` contract.
    nullspace: optional near-nullspace (n_dofs, m) for the AMG setup
    (rigid body modes for elasticity); ignored by other kinds."""
    if name in (None, "none"):
        return Precond(data=(), kind="none")
    if name == "jacobi":
        d = A.diagonal()
        inv = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)
        return Precond(data=(inv,), kind="jacobi")
    if name == "block-jacobi":
        inv = jnp.linalg.inv(A.diag_blocks())
        return Precond(data=(inv,), kind="block-jacobi")
    if name == "amg":
        # the reference's BoomerAMG/Aleph-amg preconditioner option
        # (AlephDoFLinearSystem.cc:352, HypreDoFLinearSystem.cc:698-723);
        # block systems use node aggregation (solver/amg.py)
        from .amg import build_amg

        return build_amg(A, nullspace=nullspace)
    if name == "poly":
        # Aleph poly/ainv/ic/ilu role (AlephDoFLinearSystemFactory.axl:
        # 34-43): fixed-degree Chebyshev polynomial in D^{-1}A — the
        # accelerator substitute for triangular-solve preconditioners
        from .poly import build_chebyshev

        return build_chebyshev(A)
    raise ValueError(f"unknown preconditioner '{name}'")


def _two_sum(a: Array, b: Array) -> tuple[Array, Array]:
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a: Array) -> tuple[Array, Array]:
    # Dekker split; factor 2^ceil(p/2)+1: 2^12+1 for f32, 2^27+1 for f64
    # (f64 routes through here on CPU golden runs)
    factor = 4097.0 if a.dtype == jnp.float32 else 134217729.0
    c = a * jnp.asarray(factor, a.dtype)
    big = c - (c - a)
    return big, a - big


def _two_prod(a: Array, b: Array) -> tuple[Array, Array]:
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    err = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, err


def precise_dot(a: Array, b: Array) -> Array:
    """Ogita-Rump-Oishi dot2: f32 inputs, near-f64-quality reduction.

    The mixed-precision trick that lets f32 CG reach tight residuals
    without f64 vectors (SURVEY.md §7 hard part 2).
    """
    p, e = _two_prod(a, b)
    s, comp = _two_sum(jnp.sum(p), jnp.sum(e))
    return s + comp


def default_dot(a: Array, b: Array) -> Array:
    return jnp.vdot(a, b)


@partial(jax.jit, static_argnames=("max_iter", "use_precise_dot", "chunk"))
def pcg_chunked(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
    use_precise_dot: bool = False,
    chunk: int = 4,
):
    """PCG with the tolerance test every `chunk` iterations.

    Amortizes while_loop trip overhead by running `chunk` body steps per
    tolerance check, at the price of up to chunk−1 extra iterations past
    convergence, so the plain `pcg` stays the default; chunking can pay
    off only for slow-converging systems (hundreds of iterations).
    Same stopping rule as `pcg` (preconditioned-norm relative residual).
    """
    dot = precise_dot if use_precise_dot else default_dot

    r0 = b - A.spmv(x0)
    z0 = M.apply(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    tol2 = jnp.maximum(rtol * rtol * jnp.abs(rz0), atol * atol)

    def cond(state):
        _x, _r, _z, _p, rz, k = state
        return (jnp.abs(rz) > tol2) & (k < max_iter)

    def body1(state):
        x, r, z, p, rz, k = state
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M.apply(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    def body(state):
        for _ in range(chunk):
            state = body1(state)
        return state

    x, _r, _z, _p, rz, k = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0))
    )
    rel = jnp.sqrt(
        jnp.abs(rz)
        / jnp.maximum(jnp.abs(rz0), jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype))
    )
    return x, k, rel


@partial(jax.jit, static_argnames=("max_iter", "use_precise_dot"))
def pcg(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
    use_precise_dot: bool = False,
):
    """Preconditioned conjugate gradients.

    Stopping: ||r||_C <= max(rtol * ||b||_C, atol) in the preconditioned
    norm ||v||_C = sqrt(v^T M v) — Hypre PCG's default convergence measure
    (the reference's HYPRE_ParCSRPCG path).  The preconditioned norm is what
    makes penalty-method Dirichlet rows (diag ~1e30/1e12) not drown the
    interior residual.  Returns (x, iterations, final_relative_residual).
    """
    dot = precise_dot if use_precise_dot else default_dot

    r0 = b - A.spmv(x0)
    z0 = M.apply(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    # Convergence relative to the *initial* preconditioned residual.  The
    # caller warm-starts x0 at the Dirichlet values, so penalty-row scales
    # (1e30 diagonals) cancel out of the reference norm — without the warm
    # start this degrades to the usual ||r||/||b|| criterion.
    tol2 = jnp.maximum(rtol * rtol * jnp.abs(rz0), atol * atol)

    def cond(state):
        _x, _r, _z, _p, rz, k = state
        return (jnp.abs(rz) > tol2) & (k < max_iter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M.apply(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, _r, _z, _p, rz, k = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0))
    )
    rel = jnp.sqrt(
        jnp.abs(rz)
        / jnp.maximum(jnp.abs(rz0), jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype))
    )
    return x, k, rel


def _pair_add(hi: Array, lo: Array, u: Array) -> tuple[Array, Array]:
    """(hi + lo) + u as a renormalized double-f32 pair (two_sum chain)."""
    s, e = _two_sum(hi, u)
    lo = lo + e
    hi, lo = _two_sum(s, lo)
    return hi, lo


@partial(jax.jit, static_argnames=("max_iter",))
def pcg_pair(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
):
    """Pair-precision PCG: x and r ride as double-f32 pairs.

    Keeping x and r as compensated f32 pairs (two_sum updates; both words
    enter the compensated dot) removes update-rounding ACCUMULATION from
    the recursion while the SpMV and the preconditioner stay FULL-SPEED
    f32.  Cost: ~6 extra elementwise passes per iteration — a few percent
    on nnz-bound iterations.

    Measured on the sphere_cut bench systems (tools/conv_tune.py,
    /tmp/conv_tune.jsonl): at 1.9M DoF / rtol 1e-8, plain f32 PCG with
    compensated dots ALREADY matches the f64 iteration count (21 = 21) —
    dot2 is the load-bearing compensation at that target.  pcg_pair is
    the guard for tighter targets (rtol ≲ 1e-10 in f32) and for systems
    where the update-rounding floor binds; it is exact-arithmetic
    equivalent to pcg (solutions match, tests/test_amg.py).

    The reference pipeline solves in f64 (Hypre PCG,
    HypreDoFLinearSystem.cc:686-742); f32+compensation keeps f32 vector
    traffic while approaching its accuracy.
    """
    dot = precise_dot

    zeros = jnp.zeros_like(b)
    r0 = b - A.spmv(x0)
    z0 = M.apply(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    tol2 = jnp.maximum(rtol * rtol * jnp.abs(rz0), atol * atol)

    def cond(state):
        _xh, _xl, _rh, _rl, _z, _p, rz, k = state
        return (jnp.abs(rz) > tol2) & (k < max_iter)

    def body(state):
        xh, xl, rh, rl, z, p, rz, k = state
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        xh, xl = _pair_add(xh, xl, alpha * p)
        # α·Ap enters through two_prod so its own rounding is carried too
        uh, ul = _two_prod(jnp.broadcast_to(alpha, Ap.shape), Ap)
        rh, rl = _pair_add(rh, rl, -uh)
        rl = rl - ul
        z = M.apply(rh)
        rz_new = dot(rh, z) + dot(rl, z)
        beta = rz_new / rz
        p = z + beta * p
        return (xh, xl, rh, rl, z, p, rz_new, k + 1)

    xh, xl, _rh, _rl, _z, _p, rz, k = jax.lax.while_loop(
        cond, body, (x0, zeros, r0, zeros, z0, p0, rz0, jnp.int32(0))
    )
    rel = jnp.sqrt(
        jnp.abs(rz)
        / jnp.maximum(jnp.abs(rz0),
                      jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype))
    )
    return xh + xl, k, rel


@partial(jax.jit, static_argnames=("max_iter",))
def pcg_flex(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
):
    """Flexible PCG (IPCG / Polak-Ribière beta, Golub-Ye / Notay).

    beta = z_new·(r_new − r_old) / (z_old·r_old) instead of the standard
    Fletcher-Reeves rz_new/rz — exact-arithmetic-equivalent for a FIXED
    SPD preconditioner, but robust when M varies per apply (inner
    iterative smoothers, adaptive preconditioners).  One extra
    compensated dot + one kept vector per iteration.  Probe data
    (tools/conv_tune.py, 1.9M sphere_cut): the f32 V-cycle's
    input-dependent rounding is conjugacy-benign — same 21 iterations as
    standard PCG — so this stays opt-in for genuinely variable M.
    """
    dot = precise_dot

    r0 = b - A.spmv(x0)
    z0 = M.apply(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    tol2 = jnp.maximum(rtol * rtol * jnp.abs(rz0), atol * atol)

    def cond(state):
        _x, _r, _z, _p, rz, k = state
        return (jnp.abs(rz) > tol2) & (k < max_iter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = A.spmv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M.apply(r_new)
        rz_new = dot(r_new, z_new)
        beta = (rz_new - dot(r_new, z)) / rz
        p = z_new + beta * p
        return (x, r_new, z_new, p, rz_new, k + 1)

    x, _r, _z, _p, rz, k = jax.lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0))
    )
    rel = jnp.sqrt(
        jnp.abs(rz)
        / jnp.maximum(jnp.abs(rz0),
                      jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype))
    )
    return x, k, rel


@partial(
    jax.jit, static_argnames=("max_iter", "restart", "use_precise_dot")
)
def gmres(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
    restart: int = 30,
    use_precise_dot: bool = False,
):
    """Restarted GMRES(m), right-preconditioned (the Aleph method_gmres
    role, AlephDoFLinearSystemFactory.axl:34-43).

    The Krylov basis V is a static (m+1, n) matrix; orthogonalization is
    classical Gram-Schmidt applied twice (CGS2) so the projections are two
    (m+1,n)x(n,) matvecs instead of j sequential modified-GS dots; the Hessenberg least-squares problem is
    updated with Givens rotations so the residual norm is available every
    inner step without forming residuals.  Right preconditioning keeps the
    monitored norm the TRUE residual norm ||b - A x||; convergence is
    relative to the warm-started initial residual (same contract as pcg).

    With ``use_precise_dot`` projections and norms use the compensated dot2
    (vmapped over basis rows), which lets f32 runs reach ~1e-8 relative
    residuals.  Returns (x, total_inner_iterations, rel_residual).
    """
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    dot = precise_dot if use_precise_dot else default_dot
    proj = jax.vmap(dot, in_axes=(0, None)) if use_precise_dot else None

    def basis_dots(V, w):
        # (m+1,) projections of w on every basis row (rows past j are junk
        # but masked by the caller)
        if proj is not None:
            return proj(V, w)
        return jnp.matmul(V, w)

    def norm(v):
        return jnp.sqrt(jnp.abs(dot(v, v)))

    r0 = b - A.spmv(x0)
    beta0 = norm(r0)
    tol = jnp.maximum(rtol * beta0, atol)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def inner_cond(st):
        _V, _H, _cs, _sn, _g, j, res = st
        return (j < m) & (res > tol)

    def inner_body(st):
        V, H, cs, sn, g, j, _res = st
        vj = V[j]
        w = A.spmv(M.apply(vj))
        rows = jnp.arange(m + 1)
        mask = (rows <= j).astype(dtype)
        # CGS2: two rounds of classical Gram-Schmidt
        h = basis_dots(V, w) * mask
        w = w - jnp.matmul(V.T, h)
        h2 = basis_dots(V, w) * mask
        w = w - jnp.matmul(V.T, h2)
        h = h + h2
        hnext = norm(w)
        V = V.at[j + 1].set(w / jnp.maximum(hnext, tiny))
        h = h.at[j + 1].set(hnext)

        # apply the accumulated Givens rotations to the new column
        def rot(i, hcol):
            hi, hip = hcol[i], hcol[i + 1]
            return hcol.at[i].set(cs[i] * hi + sn[i] * hip).at[i + 1].set(
                -sn[i] * hi + cs[i] * hip
            )

        h = jax.lax.fori_loop(0, j, rot, h)
        # new rotation annihilating h[j+1]
        denom = jnp.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
        denom = jnp.maximum(denom, tiny)
        c_new, s_new = h[j] / denom, h[j + 1] / denom
        h = h.at[j].set(denom).at[j + 1].set(0.0)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        gj = g[j]
        g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
        H = H.at[:, j].set(h)
        return (V, H, cs, sn, g, j + 1, jnp.abs(g[j + 1]))

    def outer_cond(st):
        _x, res, it = st
        return (res > tol) & (it < max_iter)

    def outer_body(st):
        x, _res, it = st
        r = b - A.spmv(x)
        beta = norm(r)
        V0 = jnp.zeros((m + 1, n), dtype).at[0].set(
            r / jnp.maximum(beta, tiny)
        )
        H0 = jnp.zeros((m + 1, m), dtype)
        z = jnp.zeros(m, dtype)
        g0 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        V, H, cs, sn, g, j, res = jax.lax.while_loop(
            inner_cond, inner_body, (V0, H0, z, z, g0, jnp.int32(0), beta)
        )
        # back-substitute the j x j triangular system (identity padding on
        # unused rows keeps the solve well-defined at any j)
        rows = jnp.arange(m)
        used = rows < j
        Ht = jnp.where(
            used[:, None] & used[None, :],
            H[:m, :],
            jnp.eye(m, dtype=dtype),
        )
        y = jax.scipy.linalg.solve_triangular(
            Ht, jnp.where(used, g[:m], 0.0), lower=False
        )
        x = x + M.apply(jnp.matmul(V[:m].T, y))
        return (x, res, it + j)

    x, res, iters = jax.lax.while_loop(
        outer_cond, outer_body, (x0, beta0, jnp.int32(0))
    )
    rel = res / jnp.maximum(beta0, tiny)
    return x, iters, rel


@partial(jax.jit, static_argnames=("max_iter", "use_precise_dot"))
def bicgstab(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
    use_precise_dot: bool = False,
):
    """Preconditioned BiCGStab (the Aleph method_bicgstab role,
    AlephDoFLinearSystem.cc solver-method option) for nonsymmetric systems.

    Convergence is measured on the left-preconditioned residual ||M r||_2
    (the PETSc default), for the same penalty-row-scaling reason as pcg.
    With ``use_precise_dot`` every recurrence dot runs the compensated
    dot2, which is what lets f32 nonsymmetric solves reach the same tight
    residuals as PCG.
    """
    dot = precise_dot if use_precise_dot else default_dot

    def pnorm2(r):
        mr = M.apply(r)
        return dot(mr, mr)

    r0 = b - A.spmv(x0)
    rhat = r0
    bnorm = jnp.sqrt(pnorm2(r0))  # relative to warm-started initial residual
    tol = jnp.maximum(rtol * bnorm, atol)

    def cond(state):
        _x, r, _p, _v, _rho, _alpha, _omega, k = state
        return (jnp.sqrt(pnorm2(r)) > tol) & (k < max_iter)

    def body(state):
        x, r, p, v, rho, alpha, omega, k = state
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M.apply(p)
        v = A.spmv(ph)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        sh = M.apply(s)
        t = A.spmv(sh)
        tt = dot(t, t)
        omega = jnp.where(tt > 0, dot(t, s) / tt, jnp.zeros_like(tt))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, k + 1)

    one = jnp.asarray(1.0, b.dtype)
    x, r, _p, _v, _rho, _a, _o, k = jax.lax.while_loop(
        cond,
        body,
        (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one, jnp.int32(0)),
    )
    rel = jnp.sqrt(pnorm2(r)) / jnp.maximum(
        bnorm, jnp.asarray(jnp.finfo(bnorm.dtype).tiny, bnorm.dtype)
    )
    return x, k, rel


@partial(jax.jit, static_argnames=("max_iter", "use_precise_dot"))
def bicgstab2(
    A: BellMatrix,
    b: Array,
    M: Precond,
    x0: Array,
    rtol: float,
    atol: float,
    max_iter: int,
    use_precise_dot: bool = False,
):
    """BiCGStab(2) — Sleijpen & Fokkema's BiCGstab(l) with l=2, the Aleph
    method_bicgstab2 role (AlephDoFLinearSystemFactory.axl:34-43).

    Each iteration runs two BiCG steps followed by a degree-2 minimal-
    residual polynomial update, which handles operators with complex
    eigenpairs where plain BiCGStab's degree-1 MR step stagnates.

    Right-preconditioned: the recurrence runs on A·M in y-space (the true
    residual is invariant), and the solution delta is mapped back through
    one M apply at the end — so M only needs to be linear.  Convergence is
    measured on ||M r||, matching pcg/bicgstab here.
    """
    dot = precise_dot if use_precise_dot else default_dot

    def op(z):
        return A.spmv(M.apply(z))

    def pnorm2(r):
        mr = M.apply(r)
        return dot(mr, mr)

    r0 = b - A.spmv(x0)
    rhat = r0
    bnorm = jnp.sqrt(pnorm2(r0))
    tol = jnp.maximum(rtol * bnorm, atol)
    eps = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)

    def safe_div(a, d):
        return a / jnp.where(jnp.abs(d) > eps, d, jnp.where(d < 0, -eps, eps))

    def cond(state):
        y, r, u, rho0, alpha, omega, k = state
        return (jnp.sqrt(pnorm2(r)) > tol) & (k < max_iter)

    def body(state):
        y, r, u, rho0, alpha, omega, k = state
        rho0 = -omega * rho0

        # even BiCG step
        rho1 = dot(rhat, r)
        beta = safe_div(alpha * rho1, rho0)
        rho0 = rho1
        u = r - beta * u
        v = op(u)
        gamma = dot(v, rhat)
        alpha = safe_div(rho0, gamma)
        r1 = r - alpha * v
        s = op(r1)
        y = y + alpha * u

        # odd BiCG step
        rho1 = dot(rhat, s)
        beta = safe_div(alpha * rho1, rho0)
        rho0 = rho1
        v = s - beta * v
        w = op(v)
        gamma = dot(w, rhat)
        alpha = safe_div(rho0, gamma)
        u = r1 - beta * u
        r1 = r1 - alpha * v
        s = s - alpha * w
        t = op(s)
        y = y + alpha * u

        # GCR(2): minimize ||r - omega1 s - omega2 t||
        w1 = dot(r1, s)
        mu = dot(s, s)
        nu = dot(s, t)
        tau = dot(t, t)
        w2 = dot(r1, t)
        tau = tau - safe_div(nu * nu, mu)
        omega2 = safe_div(w2 - safe_div(nu * w1, mu), tau)
        omega1 = safe_div(w1 - nu * omega2, mu)
        y = y + omega1 * r1 + omega2 * s
        r1 = r1 - omega1 * s - omega2 * t
        u = u - omega1 * v - omega2 * w
        return (y, r1, u, rho0, alpha, omega2, k + 1)

    one = jnp.asarray(1.0, b.dtype)
    y, r, _u, _rho, _a, _o, k = jax.lax.while_loop(
        cond,
        body,
        (jnp.zeros_like(b), r0, jnp.zeros_like(b), one, one, one,
         jnp.int32(0)),
    )
    x = x0 + M.apply(y)
    rel = jnp.sqrt(pnorm2(r)) / jnp.maximum(
        bnorm, jnp.asarray(jnp.finfo(bnorm.dtype).tiny, bnorm.dtype)
    )
    return x, k, rel
