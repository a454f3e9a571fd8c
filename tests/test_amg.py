"""Aggregation AMG: setup invariants + V-cycle PCG convergence win.

The reference preconditions CG with one BoomerAMG V-cycle
(HypreDoFLinearSystem.cc:686-742); this checks the aggregation AMG fills
that role on unstructured BELL systems: same solution as Jacobi-PCG in a
fraction of the iterations.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from arcanefem_tpu.fem.bcs import dtype_safe_penalty
from arcanefem_tpu.fem.problem import FemProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh
from arcanefem_tpu.ops import elements
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu.solver.iterative import Precond, pcg


def _poisson_system(n=14):
    mesh = box_tetra_mesh(n, n, n)
    prob = FemProblem(mesh, ndof=1, dtype=np.float64)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    bnodes = np.unique(
        np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    )
    gv = np.zeros(mesh.n_nodes)
    gv[mesh.coords[:, 0] > 1.0 - 1e-9] = 1.0
    pen = dtype_safe_penalty(1e30, np.float64)
    mask = np.zeros(mesh.n_nodes, bool)
    mask[bnodes] = True
    vals = A.flat_values().reshape(-1)
    d = jnp.asarray(A.topo.diag_slot)
    vals = vals.at[d].set(jnp.where(jnp.asarray(mask), pen, vals[d]))
    A = A.with_values(vals)
    rhs = jnp.where(jnp.asarray(mask), pen * jnp.asarray(gv), 1.0)
    x0 = jnp.asarray(np.where(mask, gv, 0.0))
    return A, rhs, x0


def test_amg_beats_jacobi_and_matches():
    A, rhs, x0 = _poisson_system()

    d = A.diagonal()
    MJ = Precond(
        data=(jnp.where(d != 0, 1 / jnp.where(d == 0, 1, d), 0.0),),
        kind="jacobi",
    )
    xj, kj, _ = pcg(A, rhs, MJ, x0, 1e-10, 0.0, 3000)

    M = build_amg(A)
    assert len(M.mats) >= 1, "hierarchy should have at least one level"
    xa, ka, ra = pcg(A, rhs, M, x0, 1e-10, 0.0, 3000)

    assert int(ka) < int(kj) / 2, f"AMG {int(ka)} vs Jacobi {int(kj)} iters"
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xj), atol=2e-7)


def test_amg_aggregates_cover_all_nodes():
    from arcanefem_tpu.solver.amg import _aggregate
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    n = 500
    # random symmetric strength graph
    i = rng.randint(0, n, 3000)
    j = rng.randint(0, n, 3000)
    S = sp.csr_matrix((np.ones(6000), (np.r_[i, j], np.r_[j, i])), shape=(n, n))
    agg, na = _aggregate(S, n)
    assert (agg >= 0).all() and agg.max() == na - 1
    # every aggregate non-empty
    assert len(np.unique(agg)) == na


def test_aggregate_pathological_graphs_bounded():
    """Hub/chain strength graphs must not produce unbounded aggregates
    (VERDICT r4 #8: the failure mode is silent convergence loss)."""
    from arcanefem_tpu.solver.amg import _AGG_CAP, _aggregate
    import scipy.sparse as sp

    # star: one hub strongly connected to every leaf — pass 2 must not
    # pile all leftover leaves onto the hub's aggregate
    n = 4001
    i = np.zeros(n - 1, np.int64)
    j = np.arange(1, n)
    S = sp.csr_matrix(
        (np.ones(2 * (n - 1)), (np.r_[i, j], np.r_[j, i])), shape=(n, n))
    agg, na = _aggregate(S, n)
    assert (agg >= 0).all()
    sizes = np.bincount(agg, minlength=na)
    assert sizes.max() <= 2 * _AGG_CAP, f"star max size {sizes.max()}"

    # chain: 1D path graph — aggregates stay small by construction, and
    # every node must still be covered
    n = 3000
    i = np.arange(n - 1)
    j = i + 1
    S = sp.csr_matrix(
        (np.ones(2 * (n - 1)), (np.r_[i, j], np.r_[j, i])), shape=(n, n))
    agg, na = _aggregate(S, n)
    assert (agg >= 0).all()
    sizes = np.bincount(agg, minlength=na)
    assert sizes.max() <= 8, f"chain max size {sizes.max()}"
    assert na >= n // 8


def test_amg_coarse_only_dense():
    """Tiny system: no levels, pure dense-inverse preconditioner."""
    A, rhs, x0 = _poisson_system(4)
    M = build_amg(A, coarse_size=10_000)
    assert len(M.mats) == 0
    x, k, _ = pcg(A, rhs, M, x0, 1e-10, 0.0, 50)
    assert int(k) <= 2, f"dense-preconditioned CG took {int(k)}"


def test_amg_block_elasticity():
    """Node-aggregation AMG on a vector (block=2) elasticity system."""
    from arcanefem_tpu.mesh.generate import rect_tria_mesh
    from arcanefem_tpu.models.elasticity import element_blocks, lame

    mesh = rect_tria_mesh(40, 40)
    prob = FemProblem(mesh, ndof=2, dtype=np.float64)
    lam, mu2 = lame(3.0e5, 0.3)
    A = prob.assemble_matrix(lambda ct, xyz: element_blocks(ct, xyz, lam, mu2))
    pen = dtype_safe_penalty(1e30, np.float64)
    left = mesh.group_nodes("left")
    mask = np.zeros(prob.n_dofs, bool)
    for comp in range(2):
        mask[prob.dof_ids(left, comp)] = True
    vals = A.flat_values().reshape(-1, 2, 2)
    dslots = jnp.asarray(A.topo.diag_slot)
    dm = jnp.asarray(mask.reshape(-1, 2))
    db = vals[dslots]
    db = jnp.where(dm[:, :, None] | dm[:, None, :], 0.0, db)
    db = db.at[:, 0, 0].set(jnp.where(dm[:, 0], pen, db[:, 0, 0]))
    db = db.at[:, 1, 1].set(jnp.where(dm[:, 1], pen, db[:, 1, 1]))
    vals = vals.at[dslots].set(db)
    A = A.with_values(vals.reshape(A.values.shape))
    rhs = jnp.where(jnp.asarray(mask), 0.0, 1.0)
    x0 = jnp.zeros(prob.n_dofs)

    inv = jnp.linalg.inv(A.diag_blocks())
    MB = Precond(data=(inv,), kind="block-jacobi")
    xb, kb, _ = pcg(A, rhs, MB, x0, 1e-10, 0.0, 8000)

    from arcanefem_tpu.solver.amg import build_amg

    M = build_amg(A)
    assert len(M.mats) >= 1
    xa, ka, _ = pcg(A, rhs, M, x0, 1e-10, 0.0, 8000)
    assert int(ka) < int(kb) / 2, f"AMG {int(ka)} vs block-jacobi {int(kb)}"
    np.testing.assert_allclose(
        np.asarray(xa), np.asarray(xb), rtol=1e-5, atol=1e-8
    )


def test_amg_rigid_body_modes_improve_elasticity():
    """RBM near-nullspace (solver/amg.py::rigid_body_modes) beats the
    translations-only tentative prolongator on 2D elasticity — the classic
    SA elasticity recipe (the BoomerAMG interp-vectors role)."""
    from arcanefem_tpu.mesh.generate import rect_tria_mesh
    from arcanefem_tpu.models.elasticity import element_blocks, lame
    from arcanefem_tpu.solver.amg import build_amg, rigid_body_modes

    mesh = rect_tria_mesh(40, 40)
    prob = FemProblem(mesh, ndof=2, dtype=np.float64)
    lam, mu2 = lame(3.0e5, 0.3)
    A = prob.assemble_matrix(lambda ct, xyz: element_blocks(ct, xyz, lam, mu2))
    pen = dtype_safe_penalty(1e30, np.float64)
    left = mesh.group_nodes("left")
    mask = np.zeros(prob.n_dofs, bool)
    for comp in range(2):
        mask[prob.dof_ids(left, comp)] = True
    vals = A.flat_values().reshape(-1, 2, 2)
    dslots = jnp.asarray(A.topo.diag_slot)
    dm = jnp.asarray(mask.reshape(-1, 2))
    db = vals[dslots]
    db = jnp.where(dm[:, :, None] | dm[:, None, :], 0.0, db)
    db = db.at[:, 0, 0].set(jnp.where(dm[:, 0], pen, db[:, 0, 0]))
    db = db.at[:, 1, 1].set(jnp.where(dm[:, 1], pen, db[:, 1, 1]))
    vals = vals.at[dslots].set(db)
    A = A.with_values(vals.reshape(A.values.shape))
    rhs = jnp.where(jnp.asarray(mask), 0.0, 1.0)
    x0 = jnp.zeros(prob.n_dofs)

    Mt = build_amg(A)
    xt, kt, _ = pcg(A, rhs, Mt, x0, 1e-10, 0.0, 8000)

    B = rigid_body_modes(mesh.coords, 2)
    assert B.shape == (prob.n_dofs, 3)
    Mr = build_amg(A, nullspace=B)
    xr, kr, _ = pcg(A, rhs, Mr, x0, 1e-10, 0.0, 8000)
    assert int(kr) < int(kt), f"RBM {int(kr)} vs translations {int(kt)}"
    np.testing.assert_allclose(
        np.asarray(xr), np.asarray(xt), rtol=1e-5, atol=1e-8
    )


def test_rbm_tentative_exactly_interpolates_nullspace():
    """T @ Bc == B on aggregated rows (the SA nullspace recursion
    invariant), including rank-deficient singleton aggregates."""
    from arcanefem_tpu.solver.amg import _rbm_tentative, rigid_body_modes

    rng = np.random.RandomState(0)
    nn = 23
    coords = rng.rand(nn, 2)
    B = rigid_body_modes(coords, 2)
    # aggregates of mixed size incl. singletons; one unaggregated node
    agg = np.array([i // 4 for i in range(20)] + [5, 6, -1])
    T, Bc = _rbm_tentative(agg, 7, B, 2)
    got = np.asarray((T @ Bc))
    want = np.asarray(B)
    sel = np.repeat(agg >= 0, 2)
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-10, atol=1e-12)
    assert np.all(got[~sel] == 0.0)


def test_amg_chebyshev_smoother():
    """Chebyshev(2) level smoother: same solution, fewer PCG iterations
    than the damped-Jacobi V(1,1) (measured 40->25 at 268k nodes)."""
    A, rhs, x0 = _poisson_system()

    Mj = build_amg(A)
    xj, kj, _ = pcg(A, rhs, Mj, x0, 1e-10, 0.0, 3000)

    Mc = build_amg(A, smoother="chebyshev", cheb_deg=2)
    xc, kc, rc = pcg(A, rhs, Mc, x0, 1e-10, 0.0, 3000)

    assert int(kc) <= int(kj), f"cheb {int(kc)} vs jacobi {int(kj)}"
    np.testing.assert_allclose(np.asarray(xc), np.asarray(xj), atol=2e-7)


def test_bf16_vcycle_iteration_parity():
    """bf16-precision level operators are preconditioner-rate-only: PCG
    with a bf16-quantized V-cycle must converge to the same answer within
    a couple of extra iterations (level values and transfers round-tripped
    through bfloat16; the Krylov operator stays full precision)."""
    from dataclasses import replace

    A, rhs, x0 = _poisson_system()
    M = build_amg(A)
    xa, ka, _ = pcg(A, rhs, M, x0, 1e-10, 0.0, 3000)

    def quant(m):
        v = m.values.astype(jnp.bfloat16).astype(m.values.dtype)
        return m.with_values(v.reshape(v.shape[0], -1))

    Mq = replace(
        M,
        mats=tuple(quant(m) for m in M.mats),
        pvals=tuple(
            p.astype(jnp.bfloat16).astype(p.dtype) for p in M.pvals),
        ptvals=tuple(
            p.astype(jnp.bfloat16).astype(p.dtype) for p in M.ptvals),
    )
    xq, kq, _ = pcg(A, rhs, Mq, x0, 1e-10, 0.0, 3000)

    assert int(kq) <= int(ka) + 3, f"bf16 V-cycle {int(kq)} vs f32 {int(ka)}"
    np.testing.assert_allclose(np.asarray(xq), np.asarray(xa), atol=2e-7)


def test_coarse_inverse_singular_fallback():
    """_coarse_inverse: singular coarse operators (aggressive P truncation
    can produce them) fall back to a row-scaled pseudo-inverse instead of
    crashing setup; penalty-scale diagonals must not set the rcond scale."""
    from arcanefem_tpu.solver.amg import _coarse_inverse

    # nonsingular: exact inverse
    A = np.array([[4.0, 1.0], [1.0, 3.0]])
    np.testing.assert_allclose(_coarse_inverse(A) @ A, np.eye(2), atol=1e-12)

    # singular (duplicate rows) + a 1e12 penalty row: pinv solve must still
    # invert the well-conditioned physical block exactly
    S = np.array([
        [1e12, 0.0, 0.0, 0.0],
        [0.0, 2.0, 1.0, 1.0],
        [0.0, 1.0, 2.0, 1.0],
        [0.0, 1.0, 1.0, 1.0],  # row3 = row1+row2-ish? keep singular:
    ])
    S[3] = S[1] + S[2]  # exactly dependent -> singular
    Si = _coarse_inverse(S)
    assert np.all(np.isfinite(Si))
    # acts as a least-squares solve: S @ Si @ S == S
    np.testing.assert_allclose(S @ Si @ S, S, rtol=1e-8, atol=1e-6)
    # the penalty row still inverts to 1e-12, not zeroed by rcond
    np.testing.assert_allclose(Si[0, 0], 1e-12, rtol=1e-8)


def test_theta003_converges_with_leaner_hierarchy():
    """The bench's tuned strength threshold (theta=0.03, BENCH_AMG_THETA):
    on 3D P1 Poisson it must produce a LEANER hierarchy (lower operator
    complexity) without losing convergence vs the generic 0.08 default
    (at 2.1M sphere_cut it wins both axes: 26->21 iters, opc 1.456->1.221;
    tools/conv_tune.py).  Iteration counts are platform-independent —
    this is the regression guard for the tuned bench configuration."""
    A, rhs, x0 = _poisson_system(16)

    def opc(M):
        return sum(np.asarray(m.values).size for m in M.mats) / float(
            np.asarray(M.mats[0].values).size)

    M8 = build_amg(A, smoother="chebyshev")
    M3 = build_amg(A, smoother="chebyshev", theta=0.03)
    x8, k8, _ = pcg(A, rhs, M8, x0, 1e-10, 0.0, 3000)
    x3, k3, _ = pcg(A, rhs, M3, x0, 1e-10, 0.0, 3000)

    assert opc(M3) <= opc(M8) + 1e-9, (opc(M3), opc(M8))
    assert int(k3) <= int(k8) + 2, f"theta.03 {int(k3)} vs .08 {int(k8)}"
    np.testing.assert_allclose(np.asarray(x3), np.asarray(x8), atol=2e-7)


def test_per_level_cheb_degree():
    """cheb_deg may be a per-level tuple (last entry repeats).  The
    smoother must read its level's degree and still produce the same
    solution; build_sharded_amg shifts the tuple with the stripped level."""
    A, rhs, x0 = _poisson_system()
    M = build_amg(A, smoother="chebyshev",
                  cheb_deg=(2, 4, 5))
    assert M._deg(0) == 2 and M._deg(1) == 4
    assert M._deg(2) == 5 and M._deg(9) == 5  # last entry repeats
    x, k, _ = pcg(A, rhs, M, x0, 1e-10, 0.0, 3000)
    M2 = build_amg(A, smoother="chebyshev")
    x2, k2, _ = pcg(A, rhs, M2, x0, 1e-10, 0.0, 3000)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x2), atol=2e-7)
    # coarse smoothing can only help (never hurt) the iteration count
    assert int(k) <= int(k2) + 1


def test_wcycle_matches_and_does_not_regress():
    """cycle="W" (second visit per coarse level): same solution, iteration
    count no worse than the V-cycle (it addresses deep-level coarse-grid
    correction decay at 10M-class sizes; tools/conv_tune.py)."""
    A, rhs, x0 = _poisson_system(16)
    Mv = build_amg(A, smoother="chebyshev")
    Mw = build_amg(A, smoother="chebyshev", cycle="W")
    xv, kv, _ = pcg(A, rhs, Mv, x0, 1e-10, 0.0, 3000)
    xw, kw, _ = pcg(A, rhs, Mw, x0, 1e-10, 0.0, 3000)
    assert int(kw) <= int(kv)
    np.testing.assert_allclose(np.asarray(xw), np.asarray(xv), atol=2e-7)


def test_pcg_pair_and_flex_match_pcg():
    """pcg_pair (double-f32 iterates) and pcg_flex (Polak-Ribière beta)
    are exact-arithmetic-equivalent reformulations: same solution and
    comparable iteration counts on a fixed SPD preconditioner."""
    from arcanefem_tpu.solver.iterative import pcg_flex, pcg_pair

    A, rhs, x0 = _poisson_system()
    M = build_amg(A, smoother="chebyshev")
    x, k, _ = pcg(A, rhs, M, x0, 1e-10, 0.0, 3000, use_precise_dot=True)
    xp, kp, _ = pcg_pair(A, rhs, M, x0, 1e-10, 0.0, 3000)
    xf, kf, _ = pcg_flex(A, rhs, M, x0, 1e-10, 0.0, 3000)
    assert abs(int(kp) - int(k)) <= 2 and abs(int(kf) - int(k)) <= 2
    np.testing.assert_allclose(np.asarray(xp), np.asarray(x), atol=2e-7)
    np.testing.assert_allclose(np.asarray(xf), np.asarray(x), atol=2e-7)


def test_truncate_rows_never_amplifies_cancelling_rows():
    """Row-sum-preserving truncation must not blow up rows whose kept
    entries nearly cancel: the fresh 1.9M sphere_cut hierarchy produced a
    NaN coarse Galerkin operator when a mixed-sign smoothed-P row's kept
    sum was ~1e-10 of its full sum and the rescale multiplied survivors by
    ~1e10 (ROADMAP round-3 "AMG NaN forensics").  The scale is now gated
    on the kept entries carrying the row's mass and clipped to [-4, 4]."""
    import scipy.sparse as sp

    from arcanefem_tpu.solver.amg import truncate_rows

    # row 0: benign wide row (truncates + rescales normally)
    # row 1: 10 entries of +1 and one entry of +1e-9; kmax drops nothing
    #        below rel threshold except tiny ones -> fine
    # row 2: cancelling row — kept entries sum to 1e-12, full sum 0.5
    rows, cols, dat = [], [], []
    rows += [0] * 12
    cols += list(range(12))
    dat += [1.0] * 12
    rows += [1] * 3
    cols += [0, 1, 2]
    dat += [1.0, 1.0, 1e-9]
    rows += [2] * 10
    cols += list(range(10))
    # 9 large alternating entries cancelling to ~0, one small +0.5 that
    # the kmax=8 cut drops -> kept sum ~1e-12, full sum ~0.5
    dat += [1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1e-12, 0.5]
    P = sp.csr_matrix((dat, (rows, cols)), shape=(3, 12))
    Q = truncate_rows(P, kmax=8, rel=0.0)
    q = Q.toarray()
    assert np.all(np.isfinite(q))
    # no surviving entry may be amplified by more than the 4x clip
    assert np.abs(q).max() <= 4.0 + 1e-12
    # benign rows keep their row sums exactly (constant interpolation)
    np.testing.assert_allclose(q[0].sum(), 12.0, rtol=1e-12)


def test_truncate_rows_no_overflow_warning():
    """The rescale division must not even COMPUTE full/kept on rows that
    fail the mass gate: a subnormal kept-sum overflows to inf under the
    old unconditional divide (the round-3 RuntimeWarning, VERDICT r3 #6),
    and warnings-as-errors turns that latent path into a crash."""
    import warnings

    import scipy.sparse as sp

    from arcanefem_tpu.solver.amg import truncate_rows

    # kept sum is subnormal (~5e-324): full/kept would overflow to inf
    rows = [0] * 10
    cols = list(range(10))
    dat = [1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 5e-324, 0.7]
    P = sp.csr_matrix((dat, (rows, cols)), shape=(1, 10))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Q = truncate_rows(P, kmax=8, rel=0.0)
    assert np.all(np.isfinite(Q.toarray()))


def test_galerkin_nan_fails_loudly(monkeypatch):
    """A non-finite Galerkin operator must raise, not be silently
    absorbed by the pinv coarse fallback (VERDICT r3 #6)."""
    from arcanefem_tpu.solver import amg as amg_mod

    A, _, _ = _poisson_system(8)

    def bad_truncate(P, **kw):
        Q = P.tocsr().copy()
        if len(Q.data):
            Q.data[0] = np.nan
        return Q

    monkeypatch.setattr(amg_mod, "truncate_rows", bad_truncate)
    # the native setup path bypasses truncate_rows — force the scipy
    # branch the injection targets (the finite-check guards BOTH paths)
    monkeypatch.setenv("AFEM_NATIVE_AMG", "0")
    with pytest.raises(FloatingPointError, match="non-finite Galerkin"):
        amg_mod.build_amg(A, coarse_size=8)
