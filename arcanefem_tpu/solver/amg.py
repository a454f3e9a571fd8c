"""Aggregation AMG preconditioner for unstructured (BELL) systems.

The BoomerAMG role (reference femutils/HypreDoFLinearSystem.cc:686-742:
one AMG V-cycle preconditioning each CG iteration) for meshes where the
geometric hierarchy of solver/multigrid.py does not apply.

Smoothed aggregation (Vanek/Mandel/Brezina): tentative piecewise-constant
aggregates smoothed by one damped-Jacobi step, P = (I − ω D⁻¹A)·T.  The
device part is the *representation*: P and P^T are stored as padded
row-ELL (pcols/pvals, ptcols/ptvals), so prolongation and restriction are
static gather+einsum passes — regular, static-shape, compiler-friendly ops
(no dynamic sparse formats on device).  The V-cycle is damped-Jacobi or
Chebyshev smoothing over BellMatrix SpMVs, with a dense inverse at the
coarsest level.  Setup (strength filter, greedy
Vanek aggregation, prolongator smoothing, Galerkin triple product) runs
once on the host with scipy.sparse; the apply path is pure jit.

Block (vector) systems are handled by NODE aggregation on the Frobenius
norms of the b×b coupling blocks.  The tentative prolongator is either
component-preserving (T = agg ⊗ I_b, the translations-only nullspace) or,
when a near-nullspace matrix is supplied (rigid-body modes from the node
coordinates — the classic SA elasticity recipe), a per-aggregate SVD
orthonormalization of the restricted nullspace with the R factor carried
down as the next level's nullspace.  Coarse levels then have m dofs per
aggregate (m = #modes: 3 in 2D, 6 in 3D) and the same smoothing/Galerkin
machinery recurses on the scalar expansion.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.bell import BellMatrix
from ..sparse.topology import Topology


def _ell_from_csr(indptr: np.ndarray, cols: np.ndarray) -> Topology:
    """Minimal Topology (SpMV fields only) for a host-built CSR graph."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    W = max(int(deg.max()), 1)
    ell_cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], W, axis=1)
    ell_valid = np.zeros((n, W), bool)
    idx = np.arange(len(cols))
    slot = idx - np.repeat(indptr[:-1], deg)
    rows = np.repeat(np.arange(n), deg)
    ell_cols[rows, slot] = cols.astype(np.int32)
    ell_valid[rows, slot] = True
    flat = rows * W + slot
    diag_pos = cols == rows
    diag_slot = np.zeros(n, np.int32)
    diag_slot[rows[diag_pos]] = flat[diag_pos].astype(np.int32)
    return Topology(
        n_nodes=n, width=W, ell_cols=ell_cols, ell_valid=ell_valid,
        row_ptr=indptr.astype(np.int32), csr_cols=cols.astype(np.int32),
        csr_to_ell=flat.astype(np.int32), diag_slot=diag_slot,
        slot_maps={},
    )


def rigid_body_modes(coords: np.ndarray, b: int) -> np.ndarray:
    """Near-nullspace B (n·b, m) of linear elasticity: m=3 modes in 2D
    (tx, ty, rotation), m=6 in 3D (3 translations + 3 rotations).

    Coordinates are centered so rotation columns stay O(mesh size).
    The Hypre equivalent is BoomerAMG's interp-vectors / GM elasticity
    options; PyAMG calls this B in smoothed_aggregation_solver.
    """
    c = np.asarray(coords, np.float64)
    c = c - c.mean(axis=0, keepdims=True)
    n = c.shape[0]
    if b == 2:
        B = np.zeros((n * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -c[:, 1]
        B[1::2, 2] = c[:, 0]
        return B
    if b == 3:
        B = np.zeros((n * 3, 6))
        for a in range(3):
            B[a::3, a] = 1.0
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        B[1::3, 3], B[2::3, 3] = -z, y  # rot about x
        B[0::3, 4], B[2::3, 4] = z, -x  # rot about y
        B[0::3, 5], B[1::3, 5] = -y, x  # rot about z
        return B
    raise ValueError(f"rigid body modes need b in (2, 3), got {b}")


def _rbm_tentative(agg: np.ndarray, na: int, B: np.ndarray, bl: int):
    """Tentative prolongator from a near-nullspace: per-aggregate SVD.

    Returns (T (n, na*m) csr, Bc (na*m, m)) with T's aggregate column
    blocks orthonormal (Q of Ba = Q·R) and Bc = R so T @ Bc == B on
    aggregated rows — the smoothed-aggregation nullspace recursion.
    Rank-deficient aggregates (singletons can't represent rotations)
    get their surplus columns zeroed; the corresponding coarse dofs have
    ~zero rows everywhere and are inert in the V-cycle.
    """
    import scipy.sparse as sp

    nn = len(agg)
    m = B.shape[1]
    sel = np.flatnonzero(agg >= 0)
    order = np.argsort(agg[sel], kind="stable")
    nodes_sorted = sel[order]
    aggs_sorted = agg[sel][order]
    counts = np.bincount(aggs_sorted, minlength=na)
    kmax = max(int(counts.max()), 1)
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(nodes_sorted)) - starts[aggs_sorted]
    pad = np.full((na, kmax), -1, np.int64)
    pad[aggs_sorted, slot] = nodes_sorted
    node_mask = pad >= 0  # (na, kmax)
    dofrows = (
        np.maximum(pad, 0)[:, :, None] * bl + np.arange(bl)[None, None, :]
    ).reshape(na, kmax * bl)
    dmask = np.repeat(node_mask, bl, axis=1)
    Tcols_data = np.zeros((na, kmax * bl, m))
    Bc = np.zeros((na, m, m))
    # chunked batched SVD (memory: chunk * kmax*bl * m)
    chunk = max(1, 50_000_000 // max(kmax * bl * m, 1))
    for lo in range(0, na, chunk):
        hi = min(lo + chunk, na)
        Ba = np.where(
            dmask[lo:hi, :, None], B[dofrows[lo:hi], :], 0.0
        )  # (c, kbl, m)
        U, S, Vt = np.linalg.svd(Ba, full_matrices=False)
        keep = S > np.maximum(S[:, :1] * 1e-10, 1e-12)
        Tcols_data[lo:hi] = U * (keep[:, None, :] * 1.0)
        Bc[lo:hi] = S[:, :, None] * Vt
    rows = np.broadcast_to(
        dofrows[:, :, None], (na, kmax * bl, m)
    ).reshape(-1)
    cols = (
        np.arange(na)[:, None, None] * m + np.arange(m)[None, None, :]
    )
    cols = np.broadcast_to(cols, (na, kmax * bl, m)).reshape(-1)
    data = (Tcols_data * dmask[:, :, None]).reshape(-1)
    nzsel = data != 0.0
    T = sp.csr_matrix(
        (data[nzsel], (rows[nzsel], cols[nzsel])),
        shape=(nn * bl, na * m),
    )
    return T, Bc.reshape(na * m, m)


# pass-2 aggregate-size cap: typical 3D aggregates are ~25-60 nodes
# (root + strong neighbourhood + one pass-2 shell); 128 leaves real
# meshes untouched while bounding hub pathologies (see pass 2 below)
_AGG_CAP = 128


def _aggregate(S, n: int) -> tuple[np.ndarray, int]:
    """Greedy Vanek aggregation on the strength graph S (scipy csr).

    Rows with NO strong neighbour keep agg = -1: they get no coarse
    representation at all (empty tentative-prolongator row).  This is
    what isolates penalty/Dirichlet rows — their 1e30 diagonals fail
    every strength test, and including them in an aggregate would swamp
    that coarse row and zero the correction for every regular node in it.
    The smoother handles them exactly instead (diag-dominant rows).
    """
    indptr, cols = S.indptr, S.indices
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n), deg)
    agg = np.full(n, -1, np.int64)
    isolated = deg == 0
    na = 0
    # pass 1, vectorised Luby-style rounds: a node roots an aggregate when
    # it and its whole strong neighbourhood are free AND it has the
    # smallest RANDOM priority in that free neighbourhood (an independent
    # set, so parallel assignment is conflict-free).  Random priorities —
    # index order is pathological on RCM/lexicographic meshes (only the
    # frontier minimum roots per round, giving size-3 sliver aggregates).
    pri = np.random.RandomState(0).permutation(n)
    rounds_used = 0
    for _ in range(64):
        free = agg < 0
        cand = free & ~isolated
        # neighbourhood entirely free?
        nb_all_free = np.ones(n, bool)
        np.logical_and.at(nb_all_free, rows, free[cols])
        cand &= nb_all_free
        # smallest priority among free candidate neighbours
        nbr_min = np.full(n, n, np.int64)
        sel = cand[rows] & cand[cols]
        np.minimum.at(nbr_min, rows[sel], pri[cols[sel]])
        roots = cand & (pri <= nbr_min)
        nr = int(roots.sum())
        if nr == 0:
            break
        rounds_used += 1
        ids = np.full(n, -1, np.int64)
        ids[roots] = na + np.arange(nr)
        agg[roots] = ids[roots]
        # members join their root (a member adjacent to several roots
        # takes the max id — any is fine)
        take = roots[rows] & (agg[cols] < 0)
        np.maximum.at(agg, cols[take], ids[rows[take]])
        na += nr
    # pass 2, vectorised: leftovers take an aggregated strong neighbour's
    # id (max over neighbours).  LIMITED to 2 rounds: iterating until
    # fixpoint lets chains of leftovers pile shell-by-shell onto the same
    # aggregate (measured max size 136 on the 300k sphere_cut, which blew
    # the Galerkin operator width up to 1700); bounded rounds keep
    # aggregate diameter ~3 and the remainder becomes fresh singletons.
    # SIZE CAP (VERDICT r4 #8): a hub node (star-like strength row) makes
    # every leftover leaf join the hub's aggregate in ONE batched round —
    # unboundedly fat aggregates, silent convergence loss.  Per round,
    # each aggregate accepts at most (_AGG_CAP - size) joiners; the rest
    # become singletons below, which only costs coarse-level size.
    for _ in range(2):
        free = agg < 0
        if not free.any():
            break
        best = np.full(n, -1, np.int64)
        sel = free[rows] & (agg[cols] >= 0)
        np.maximum.at(best, rows[sel], agg[cols][sel])
        upd = free & (best >= 0)
        if not upd.any():
            break
        sizes = np.bincount(agg[agg >= 0], minlength=na)
        joiners = np.flatnonzero(upd)
        tgt = best[joiners]
        order = np.argsort(tgt, kind="stable")
        st = tgt[order]
        # position of each joiner within its target's run
        run_start = np.concatenate([[0], np.flatnonzero(np.diff(st)) + 1])
        pos = np.arange(len(st)) - np.repeat(
            run_start, np.diff(np.concatenate([run_start, [len(st)]])))
        quota = np.maximum(_AGG_CAP - sizes[st], 0)
        keep = joiners[order[pos < quota]]
        if not len(keep):
            break
        agg[keep] = best[keep]
    # anything still free but connected becomes singleton aggregates
    left = (agg < 0) & ~isolated
    nl = int(left.sum())
    if nl:
        agg[left] = na + np.arange(nl)
        na += nl
    # quality diagnostics (VERDICT r4 #8): the failure mode of a bad
    # aggregation is SILENT (more iterations, not an error) — surface it.
    if na:
        max_sz = int(np.bincount(agg[agg >= 0], minlength=na).max())
        if max_sz > _AGG_CAP + _AGG_CAP // 2 or rounds_used >= 64:
            import warnings

            warnings.warn(
                f"_aggregate quality: max aggregate size {max_sz} "
                f"(cap {_AGG_CAP}), Luby rounds {rounds_used}/64, "
                f"{nl} singletons of {n} nodes — pathological strength "
                "graph? expect degraded AMG convergence", stacklevel=2)
    # relabel aggregates in first-member order: coarse numbering then
    # inherits the fine (RCM) locality, so coarse-level matrices and
    # transfer operators keep their gathers local
    if na:
        sel = agg >= 0
        firsts = np.full(na, n, np.int64)
        np.minimum.at(firsts, agg[sel], np.arange(n)[sel])
        rank = np.empty(na, np.int64)
        rank[np.argsort(firsts, kind="stable")] = np.arange(na)
        agg[sel] = rank[agg[sel]]
    return agg, na


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["mats", "inv_diags", "pcols", "pvals", "ptcols", "ptvals",
                 "coarse_inv"],
    meta_fields=["nu", "omegas", "smoother", "cheb_deg", "rhos",
                 "sawtooth", "cycle"],
)
@dataclass
class AMGPrecond:
    """Plain-aggregation AMG V-cycle (apply-only; setup is host-side)."""

    mats: tuple  # BellMatrix per level (finest first)
    inv_diags: tuple  # (N_l,) per level
    pcols: tuple  # (N_l, Wp) int32 row-ELL columns of the prolongator
    pvals: tuple  # (N_l, Wp) row-ELL values (0.0 on padding)
    # restriction as a GATHER: row-ELL of P^T (per coarse dof, its incoming
    # fine dofs) — deterministic, unlike a scatter-add restriction
    ptcols: tuple  # (Nc_l, Wt) int32
    ptvals: tuple  # (Nc_l, Wt)
    coarse_inv: jnp.ndarray  # dense inverse of the coarsest operator
    nu: int = 1
    # per-level damping c/ρ(D⁻¹A_l): SA Galerkin operators get stiffer with
    # depth (ρ can exceed 2), so a fixed ω diverges on coarse levels
    omegas: tuple = ()
    # "jacobi": nu damped-Jacobi sweeps pre+post.  "chebyshev": degree-
    # cheb_deg Chebyshev polynomial in D^-1 A targeting [rho/4, 1.1 rho]
    # (the Hypre/AMGX GPU-standard smoother; rho estimates in `rhos`)
    smoother: str = "jacobi"
    cheb_deg: int = 2
    rhos: tuple = ()

    def _smooth0(self, l: int, b, sweeps: int):
        om = jnp.asarray(self.omegas[l], b.dtype)
        x = om * self.inv_diags[l] * b
        for _ in range(sweeps - 1):
            x = x + om * self.inv_diags[l] * (b - self.mats[l].spmv(x))
        return x

    def _deg(self, l: int) -> int:
        """Chebyshev degree at level l: cheb_deg may be an int or a
        per-level tuple (last entry repeats for deeper levels).  Stronger
        coarse-level smoothing is nearly free — levels 1+ together carry
        only (opc-1) ≈ 0.2-0.6 of the fine level's nnz.  Measured
        (tools/conv_tune.py): coarse-degree boosts alone do NOT fix the
        8.9M iteration growth (55 -> 56 with (2,4)) — that is a
        coarse-grid-correction effect, addressed by cycle="W"."""
        cd = self.cheb_deg
        if isinstance(cd, (tuple, list)):
            return int(cd[min(l, len(cd) - 1)])
        return int(cd)

    def _cheb_params(self, l: int):
        lmax = 1.1 * self.rhos[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        return theta, delta, theta / delta

    def _smooth_cheb(self, l: int, b, x=None):
        """x_out = x + p(D^-1 A)·D^-1·(b − A x), three-term recurrence."""
        theta, delta, sigma = self._cheb_params(l)
        Al = self.mats[l]
        r = b if x is None else b - Al.spmv(x)
        d = self.inv_diags[l] * r / theta
        x = d if x is None else x + d
        rho_old = 1.0 / sigma
        for _ in range(self._deg(l) - 1):
            r = b - Al.spmv(x)
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d = (rho_new * rho_old) * d \
                + (2.0 * rho_new / delta) * self.inv_diags[l] * r
            x = x + d
            rho_old = rho_new
        return x

    def _transfer_down(self, l: int, r):
        return jnp.einsum("nw,nw->n", self.ptvals[l], r[self.ptcols[l]])

    def _transfer_up(self, l: int, xc):
        return jnp.einsum("nw,nw->n", self.pvals[l], xc[self.pcols[l]])

    # "sawtooth" variant: skip the FINE-level pre-smooth (x=0 ⇒ r=b,
    # restrict b directly) — saves the pre-smooth + residual fine SpMVs
    # per V-cycle but makes the cycle nonsymmetric.  MEASURED at 268k:
    # cheb 25→37 iters (5→3 fine SpMVs/iter: 125 vs 111, a wash once the
    # +48% of per-iteration dots/transfers is counted), jacobi 40→64.
    # Kept as a documented negative result; off by default.
    sawtooth: bool = False
    # "V" (default) or "W": W recurses twice per coarse level — only the
    # cheap levels 1+ double, and it restores iteration scalability when
    # the deep-level coarse-grid correction degrades at 10M-class sizes
    cycle: str = "V"

    def _vcycle(self, l: int, b):
        if l == len(self.mats):
            return jnp.matmul(self.coarse_inv, b)
        if l == 0 and self.sawtooth:
            rc = self._transfer_down(l, b)
            xc = self._vcycle(l + 1, rc)
            x = self._transfer_up(l, xc)
        else:
            if self.smoother == "chebyshev":
                x = self._smooth_cheb(l, b)
            else:
                x = self._smooth0(l, b, self.nu)
            r = b - self.mats[l].spmv(x)
            rc = self._transfer_down(l, r)
            xc = self._vcycle(l + 1, rc)
            x = x + self._transfer_up(l, xc)
            if self.cycle == "W" and l + 1 < len(self.mats):
                # W-cycle: second coarse visit with the updated residual.
                # Only coarse-level work doubles — levels 1+ carry just
                # (opc−1) of the fine nnz, so the extra cost is small
                # while coarse-grid-correction quality compounds.
                r = b - self.mats[l].spmv(x)
                xc = self._vcycle(l + 1, self._transfer_down(l, r))
                x = x + self._transfer_up(l, xc)
        if self.smoother == "chebyshev":
            return self._smooth_cheb(l, b, x)
        om = jnp.asarray(self.omegas[l], b.dtype)
        for _ in range(self.nu):
            x = x + om * self.inv_diags[l] * (b - self.mats[l].spmv(x))
        return x

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        return self._vcycle(0, r)


def _coarse_inverse(coarse_dense: np.ndarray) -> np.ndarray:
    """Exact inverse of the coarsest operator, with a least-squares
    fallback: aggressive prolongator truncation can leave a genuinely
    singular Galerkin coarse operator (near-duplicate aggregate columns),
    and a pinv coarse solve keeps the V-cycle a valid (semi-)
    preconditioner instead of crashing setup.  Row-scaled pinv so the
    rcond cut is per-row — penalty rows carry ~1e12/1e30 diagonals that
    would otherwise set the global singular-value scale and discard every
    physical mode."""
    d = np.abs(np.diag(coarse_dense))
    d = np.where(d > 0.0, d, 1.0)
    B = coarse_dense / d[:, None]  # row-equilibrated
    try:
        Binv = np.linalg.inv(B)
        # np.linalg.inv does NOT reliably raise on exactly-singular input
        # (LU pivot roundoff) — verify the inverse actually inverts
        resid = np.abs(B @ Binv - np.eye(B.shape[0])).max()
        if np.isfinite(resid) and resid < 1e-6:
            return Binv / d[None, :]
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(B, rcond=1e-10) / d[None, :]


def truncate_rows(P, kmax=8, rel=0.05, rescale=True):
    """Cap P's row width: keep the kmax largest-|.| entries per row
    (and drop entries below rel·rowmax), rescaling the survivors so
    each row sum is preserved — constants stay exactly interpolated.
    Unbounded SA prolongator width is what blew the Galerkin operators
    up to W=1700 on the 300k sphere_cut hierarchy.

    rescale=False for RBM prolongators: their rows mix translation and
    rotation columns, so the row sum is meaningless and near-zero sums
    produce wild scale factors (measured 2x WORSE convergence than the
    translations-only hierarchy with rescaling on)."""
    indptr, dat = P.indptr, P.data
    deg = np.diff(indptr)
    if len(dat) == 0 or int(deg.max(initial=0)) <= kmax and rel == 0:
        return P
    nr = P.shape[0]
    rows = np.repeat(np.arange(nr), deg)
    order = np.lexsort((-np.abs(dat), rows))
    rank = np.arange(len(dat)) - np.repeat(indptr[:-1], deg)
    keep = np.zeros(len(dat), bool)
    keep[order] = rank < kmax
    if rel > 0:
        rowmax = np.zeros(nr)
        np.maximum.at(rowmax, rows, np.abs(dat))
        keep &= np.abs(dat) >= rel * rowmax[rows]
    import scipy.sparse as sp

    if not rescale:
        Q = sp.csr_matrix((dat * keep, P.indices, indptr), shape=P.shape)
        Q.eliminate_zeros()
        return Q
    full = np.zeros(nr)
    kept = np.zeros(nr)
    np.add.at(full, rows, dat)
    np.add.at(kept, rows, dat * keep)
    # rescale only where the kept entries carry the row's mass, and
    # never amplify by more than 4x: a near-cancelling kept-sum
    # (mixed-sign smoothed-P rows) otherwise blows survivors up by
    # 1e6+ and poisons the Galerkin product with inf-inf=NaN — the
    # observed fresh-1.9M-hierarchy NaN that the pinv coarse fallback
    # had to absorb (round-3 "AMG NaN forensics").  The division itself
    # only runs where the row passes the mass test: full/kept with a
    # subnormal kept overflows to inf (the RuntimeWarning seen in the
    # round-3 fresh build) even when np.where then discards it.
    ok = np.abs(kept) > 0.1 * np.abs(full)
    raw = full / np.where(ok, kept, 1.0)
    scale = np.where(ok, np.clip(raw, -4.0, 4.0), 1.0)
    Q = sp.csr_matrix(
        (dat * keep * scale[rows], P.indices, indptr), shape=P.shape
    )
    Q.eliminate_zeros()
    return Q


def build_amg(
    A: BellMatrix,
    theta: float = 0.08,
    coarse_size: int = 400,
    max_levels: int = 12,
    nu: int = 1,
    omega: float = 4.0 / 3.0,  # smoother damping NUMERATOR: ω_l = omega/ρ_l
    nullspace: np.ndarray | None = None,
    smoother: str = "jacobi",
    cheb_deg: int = 2,
    trunc_kmax: int = 8,
    trunc_rel: float = 0.05,
    sawtooth: bool = False,
    cycle: str = "V",
    values_np: np.ndarray | None = None,
) -> AMGPrecond:
    """Host-side setup: strength -> aggregation -> Galerkin, per level.

    A must be a finalized (BC-applied) scalar BellMatrix; penalty rows
    become singleton aggregates (the strength filter isolates their huge
    diagonals) and are handled exactly by the Jacobi smoother.

    nullspace: optional (n_dofs, m) near-nullspace for block systems —
    rigid_body_modes(mesh.coords, b) for elasticity.  Coarse levels then
    carry m dofs per aggregate; without it block systems use the
    translations-only component-preserving tentative prolongator.
    """
    import os
    import time as _time

    import scipy.sparse as sp

    _verbose = os.environ.get("AFEM_AMG_VERBOSE") == "1"
    _t0 = _time.time()

    def _mark(label):
        nonlocal _t0
        if _verbose:
            t = _time.time()
            print(f"[amg] {label}: {t - _t0:.1f}s", flush=True)
            _t0 = t

    topo = A.topo
    b = A.block
    # values_np: the caller's HOST copy of A.values, which saves the
    # device->host fetch of the fine operator when the caller has one.
    _av = (np.asarray(values_np) if values_np is not None
           else np.asarray(A.values))
    if b == 1:
        vals = _av.reshape(topo.n_nodes, topo.width)
        data = vals.reshape(-1)[topo.csr_to_ell]
        Ah = sp.csr_matrix(
            (data.astype(np.float64), topo.csr_cols, topo.row_ptr),
            shape=(topo.n_nodes, topo.n_nodes),
        )
    else:
        # scalar expansion of the block BELL, dof = node*b + comp
        vals = _av.astype(np.float64)  # (N, W, b, b)
        N, W = topo.n_nodes, topo.width
        blocks = vals.reshape(N * W, b, b)[topo.csr_to_ell]  # (nnz, b, b)
        rows_n = np.repeat(np.arange(N), np.diff(topo.row_ptr))
        r = (rows_n[:, None, None] * b + np.arange(b)[None, :, None])
        c = (topo.csr_cols[:, None, None] * b + np.arange(b)[None, None, :])
        Ah = sp.csr_matrix(
            (
                blocks.reshape(-1),
                (
                    np.broadcast_to(r, blocks.shape).reshape(-1),
                    np.broadcast_to(c, blocks.shape).reshape(-1),
                ),
            ),
            shape=(N * b, N * b),
        )
        Ah.sum_duplicates()

    def rho_est(A_csr, d, iters=40, seed=0):
        """λmax(D⁻¹A) estimate: Lanczos on the similar SYMMETRIC operator
        S = D^-1/2 A D^-1/2 (tight from below, +8% safety), capped by S's
        Gershgorin row-sum bound (safe from above).

        The old 10-step power iteration on D⁻¹A UNDERESTIMATED λmax by up
        to 30% on the 8.9M sphere_cut (stored 1.92 vs converged ≥2.52):
        sliver elements carry localized stiff modes that power iteration
        finds slowly.  An underestimated interval makes every
        Chebyshev/Jacobi sweep AMPLIFY the top of the spectrum — the
        measured symptom was iteration growth with size (21→55 iters at
        1.9M→8.9M) that got WORSE with stronger smoothing (cheb3: 66).
        Lanczos λmax converges like the square of power iteration
        (Kaniel-Paige); no reorthogonalization needed for the extreme
        eigenvalue."""
        n = A_csr.shape[0]
        s = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))

        def Sv(v):
            return s * (A_csr @ (s * v))

        # Gershgorin on S: max_i Σ_j |s_i a_ij s_j|
        gersh = float((s * (abs(A_csr) @ s)).max())
        if not np.isfinite(gersh) or gersh == 0.0:
            return 1.0
        rng = np.random.RandomState(seed)
        v = rng.rand(n) - 0.5
        v /= np.linalg.norm(v)
        v_prev = np.zeros(n)
        alphas, betas = [], []
        beta = 0.0
        lam_hist = []

        def top_eig():
            T = np.diag(alphas)
            off = betas[:-1]
            if off:
                T += np.diag(off, 1) + np.diag(off, -1)
            return float(np.linalg.eigvalsh(T).max())

        for it in range(iters):
            w = Sv(v) - beta * v_prev
            alpha = float(v @ w)
            w -= alpha * v
            beta = float(np.linalg.norm(w))
            alphas.append(alpha)
            betas.append(beta)
            if beta < 1e-12 * max(abs(alpha), 1.0):
                break
            v_prev, v = v, w / beta
            # adaptive stop: each SpMV streams the whole level operator
            # on the host — stop once the Ritz value has stabilized to
            # 0.3% over 4 steps
            # (the Kaniel-Paige tail; the 1.08 safety factor dominates
            # any residual underestimate at that point)
            if it >= 8 and (it & 1):
                lam_hist.append((it, top_eig()))
                if len(lam_hist) >= 3:
                    l0 = lam_hist[-3][1]
                    l1 = lam_hist[-1][1]
                    if abs(l1 - l0) <= 3e-3 * max(abs(l1), 1e-30):
                        break
        lam = top_eig() if len(alphas) else gersh
        return float(min(1.08 * lam, gersh))

    # Hierarchy dtype follows the DEVICE operator, not the caller's host
    # copy (values_np is f32 in bench even when the solve is f64 on CPU;
    # reading .dtype off the jax array costs no device->host fetch) —
    # ADVICE r4.
    dtype = np.dtype(A.values.dtype)
    mats, inv_diags, Ps, rhos = [], [], [], []
    cur = Ah
    bl = b  # dofs per "node" at the current level (m on coarse RBM levels)
    Bns = np.asarray(nullspace, np.float64) if (
        nullspace is not None and b > 1
    ) else None
    used_rbm = Bns is not None
    while cur.shape[0] > coarse_size * bl and len(mats) < max_levels:
        n = cur.shape[0]
        nn = n // bl  # node count (dofs stay node-major on every level)
        # Vanek's per-level strength decay: Galerkin operators get denser
        # with depth, so the same θ keeps far too many edges there
        theta_l = theta * (0.5 ** len(mats))
        if bl > 1:
            # node-level strength on block Frobenius norms: E^T |A|² E
            # with E = I_nn ⊗ 1_b collapses each b×b block to a scalar
            E = sp.kron(
                sp.identity(nn, format="csr"),
                np.ones((bl, 1)),
                format="csr",
            )
            A2 = cur.copy()
            A2.data = A2.data**2
            nodeA = (E.T @ A2 @ E).tocsr()
            nodeA.data = np.sqrt(nodeA.data)
        else:
            nodeA = cur
        # native fused strength+filter (amg_setup.cpp, scalar levels):
        # one CSR pass replaces the scipy coo strength test AND the
        # strong-filter/searchsorted block below (~15 s of the ~40 s
        # 1.9M setup); numerics identical (see amg_setup.cpp header)
        nat_sf = None
        if (bl == 1 and Bns is None
                and os.environ.get("AFEM_NATIVE_AMG", "1") == "1"):
            from ..utils.native import amg_strength_filter_native

            cur_csr = cur.tocsr()
            nat_sf = amg_strength_filter_native(
                cur_csr.indptr, cur_csr.indices, cur_csr.data, theta_l)
        if nat_sf is not None:
            s_indptr, s_cols, _af_data, _ddf = nat_sf
            S = sp.csr_matrix(
                (np.ones(len(s_cols)), s_cols, s_indptr),
                shape=nodeA.shape,
            )
        else:
            d = np.asarray(nodeA.diagonal())
            # strength: |a_ij| >= θ_l·sqrt(a_ii·a_jj), diagonal excluded
            co = nodeA.tocoo()
            scale = np.sqrt(np.abs(d[co.row] * d[co.col])) + 1e-300
            keep = (np.abs(co.data) >= theta_l * scale) & (co.row != co.col)
            S = sp.csr_matrix(
                (co.data[keep], (co.row[keep], co.col[keep])),
                shape=nodeA.shape,
            )
        _mark(f"  strength[{len(mats)}]")
        agg, na = _aggregate(S, nn)
        _mark(f"  aggregate[{len(mats)}]")
        if na == 0 or na >= nn:  # no coarsening progress
            break
        sel = agg >= 0
        bl_next = bl
        Bc = None
        if bl > 1 and Bns is not None:
            # rigid-body-mode tentative (SA nullspace recursion)
            T, Bc = _rbm_tentative(agg, na, Bns, bl)
            bl_next = Bns.shape[1]
        elif bl > 1:
            # component-preserving tentative: dof (i, a) -> (agg[i], a)
            dsel = np.repeat(sel, bl)
            drow = np.arange(n)[dsel]
            dcol = np.repeat(agg[sel], bl) * bl + np.tile(
                np.arange(bl), int(sel.sum())
            )
            T = sp.csr_matrix(
                (np.ones(len(drow)), (drow, dcol)), shape=(n, na * bl)
            )
        else:
            T = sp.csr_matrix(
                (np.ones(int(sel.sum())), (np.arange(n)[sel], agg[sel])),
                shape=(n, na),
            )
        # prolongator smoothing on the FILTERED operator (standard SA):
        # weak (node-)connections are dropped from A and lumped onto the
        # diagonal, so smoothing spreads T only along strong edges — this
        # is what keeps P (and the Galerkin product) sparse
        if nat_sf is not None:
            # the native pass already produced Af's data (A's pattern,
            # weak entries zeroed, diagonal lumped)
            Af = sp.csr_matrix(
                (_af_data, cur_csr.indices, cur_csr.indptr),
                shape=cur.shape,
            )
            ddf = _ddf
            _mark(f"  filter[{len(mats)}]")
            rho_f = rho_est(Af, ddf)
            _mark(f"  rho_f[{len(mats)}]")
            dd = np.asarray(cur.diagonal())
            rhos.append(rho_est(cur_csr, dd))
            _mark(f"  rho_A[{len(mats)}]")
            from ..utils.native import amg_smooth_p_native

            nat_p = amg_smooth_p_native(
                cur_csr.indptr, cur_csr.indices, _af_data, ddf,
                4.0 / 3.0 / rho_f, agg, na, trunc_kmax, trunc_rel,
                rescale=not used_rbm)
        else:
            nat_p = None
        if nat_p is not None:
            p_indptr, p_cols, p_data = nat_p
            P = sp.csr_matrix((p_data, p_cols, p_indptr), shape=(n, na))
        else:
            aco = cur.tocoo()
            ni = aco.row // bl
            nj = aco.col // bl
            Sco = S.tocoo()
            skey = np.sort(Sco.row.astype(np.int64) * nn + Sco.col)
            akey = ni.astype(np.int64) * nn + nj
            if len(skey):
                pos = np.minimum(np.searchsorted(skey, akey), len(skey) - 1)
                strong = (skey[pos] == akey) | (ni == nj)
            else:
                strong = ni == nj
            af_data = np.where(strong, aco.data, 0.0)
            drop_row = np.zeros(n)
            np.add.at(drop_row, aco.row, aco.data - af_data)
            Af = sp.csr_matrix(
                (af_data, (aco.row, aco.col)), shape=cur.shape
            ) + sp.diags(drop_row)
            ddf = np.asarray(Af.diagonal())
            Dinvf = sp.diags(1.0 / np.where(ddf == 0, 1.0, ddf))
            DAf = (Dinvf @ Af).tocsr()
            _mark(f"  filter[{len(mats)}]")
            rho_f = rho_est(Af.tocsr(), ddf)
            _mark(f"  rho_f[{len(mats)}]")
            # smoother damping uses the TRUE operator's spectral radius
            dd = np.asarray(cur.diagonal())
            rhos.append(rho_est(cur.tocsr(), dd))
            _mark(f"  rho_A[{len(mats)}]")
            P = (sp.identity(n, format="csr") - (4.0 / 3.0 / rho_f) * DAf) @ T
            P = truncate_rows(P.tocsr(), kmax=trunc_kmax, rel=trunc_rel,
                              rescale=not used_rbm)
        _mark(f"  smoothP[{len(mats)}]")
        nxt = (P.T @ cur @ P).tocsr()
        nxt.sum_duplicates()
        _mark(f"  galerkin[{len(mats)}]")
        if not np.isfinite(nxt.data).all():
            # fail LOUDLY: a non-finite Galerkin operator means the
            # prolongator carried inf/NaN (historically: truncate_rows
            # rescale blow-ups).  The pinv coarse fallback used to absorb
            # this silently — a latent correctness bug, round-3 VERDICT #6.
            raise FloatingPointError(
                f"non-finite Galerkin operator at level {len(mats) + 1} "
                f"({int((~np.isfinite(nxt.data)).sum())} bad entries); "
                "prolongator scaling bug — do not silently self-heal"
            )

        mats.append(cur)
        Ps.append(P)
        cur = nxt
        bl = bl_next
        Bns = Bc
        _mark(f"level {len(mats)-1} ({n}->{cur.shape[0]} dofs)")

    def to_bell(M) -> BellMatrix:
        M = M.tocsr()
        M.sum_duplicates()
        t = _ell_from_csr(M.indptr, M.indices)
        v = np.zeros(t.n_nodes * t.width, dtype)
        v[t.csr_to_ell] = M.data.astype(dtype)
        vals = v.reshape(t.n_nodes, t.width)
        bm = BellMatrix(
            values=jnp.asarray(vals[..., None, None]),
            topo=t, block=1, cols=jnp.asarray(t.ell_cols),
        )
        return bm

    bell_mats = []
    for li, M in enumerate(mats):
        bm = to_bell(M)
        _mark(f"to_bell[{li}] (n={M.shape[0]})")
        # inverse diagonal on the host: one transfer per level instead of
        # a small compiled device program each
        d = np.asarray(M.tocsr().diagonal(), dtype)
        inv_diags.append(
            jnp.asarray(np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0))
        )
        bell_mats.append(bm)

    def p_ell(P):
        deg = np.diff(P.indptr)
        Wp = max(int(deg.max()), 1)
        pc = np.zeros((P.shape[0], Wp), np.int32)
        pv = np.zeros((P.shape[0], Wp), dtype)
        rows = np.repeat(np.arange(P.shape[0]), deg)
        slot = np.arange(len(P.indices)) - np.repeat(P.indptr[:-1], deg)
        pc[rows, slot] = P.indices.astype(np.int32)
        pv[rows, slot] = P.data.astype(dtype)
        return jnp.asarray(pc), jnp.asarray(pv)

    pcols, pvals, ptcols, ptvals = [], [], [], []
    for P in Ps:
        pc, pv = p_ell(P)
        pcols.append(pc)
        pvals.append(pv)
        PT = P.T.tocsr()
        PT.sum_duplicates()
        tc, tv = p_ell(PT)
        ptcols.append(tc)
        ptvals.append(tv)
        _mark(f"transfers[{len(pcols)-1}]")

    if cur.shape[0] > 8 * coarse_size * bl:
        # aggregation stalled (or max_levels hit early) far above the target
        # coarse size — a dense inverse here would be O(n^3); fail loudly
        # instead of silently degrading setup
        raise RuntimeError(
            f"AMG coarsening stalled at {cur.shape[0]} dofs "
            f"(target coarse size {coarse_size * bl}, {len(mats)} levels); "
            "loosen theta or raise max_levels/coarse_size"
        )
    coarse_dense = cur.toarray()
    if used_rbm:
        # rank-deficient aggregates (singletons can't carry rotations)
        # leave inert all-zero rows/cols in the coarsest operator; give
        # them identity rows so the exact inverse exists (their residual
        # is identically zero, so the correction stays zero).  NOT pinv:
        # a relative rcond against 1e30 penalty diagonals would discard
        # every physical mode.
        zero_rows = ~np.any(coarse_dense != 0.0, axis=1)
        if zero_rows.any():
            idx = np.flatnonzero(zero_rows)
            coarse_dense[idx, idx] = 1.0
    coarse_inv = jnp.asarray(_coarse_inverse(coarse_dense).astype(dtype))
    return AMGPrecond(
        mats=tuple(bell_mats),
        inv_diags=tuple(inv_diags),
        pcols=tuple(pcols),
        pvals=tuple(pvals),
        ptcols=tuple(ptcols),
        ptvals=tuple(ptvals),
        coarse_inv=coarse_inv,
        nu=nu,
        omegas=tuple(omega / r for r in rhos),
        smoother=smoother,
        cheb_deg=cheb_deg,
        rhos=tuple(float(r) for r in rhos),
        sawtooth=sawtooth,
        cycle=cycle,
    )
