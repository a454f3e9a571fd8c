"""ILU(0)/IC(0) vs Chebyshev-polynomial preconditioning: the decision
experiment for the last partial COMPONENTS row (VERDICT r4 #9).

The reference's Aleph backend offers ainv/ic/ilu/ilup preconditioners
(AlephDoFLinearSystem.cc:344-379); this repo substitutes one Chebyshev
polynomial (solver/poly.py) for all four.  This script produces the
evidence for that substitution on CPU (iteration counts are
platform-independent):

  1. PCG iterations to rtol 1e-8 with jacobi / chebyshev(3) / ILU (scipy
     spilu at fill_factor=1 ~ ILU(0), and a stronger ILUT) on three
     repo-assembled systems (2D poisson, 3D poisson, 2D elasticity).
  2. The device cost model for a triangular solve: the level-schedule
     depth of L (longest dependency chain).  Each level is a separate
     dependent device step; at the ~10-50 us/step kernel-launch floor the
     solve latency is depth-bound regardless of flops, while cheb(3)
     costs exactly 3 SpMVs.

Writes .cache/queue_results/ilu_decision.json and prints a summary.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from arcanefem_tpu.utils import device  # noqa: E402

device.setup(cpu=True, x64=True)

import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spla  # noqa: E402


def csr_of(A_bell):
    topo = A_bell.topo
    b = A_bell.block
    n, W = topo.n_nodes, topo.width
    vals = np.asarray(A_bell.values, np.float64)
    if b == 1:
        data = vals.reshape(-1)[topo.csr_to_ell]
        return sp.csr_matrix((data, topo.csr_cols, topo.row_ptr),
                             shape=(n, n))
    blocks = vals.reshape(n * W, b, b)[topo.csr_to_ell]
    rows_n = np.repeat(np.arange(n), np.diff(topo.row_ptr))
    r = rows_n[:, None, None] * b + np.arange(b)[None, :, None]
    c = topo.csr_cols[:, None, None] * b + np.arange(b)[None, None, :]
    M = sp.csr_matrix(
        (blocks.reshape(-1),
         (np.broadcast_to(r, blocks.shape).reshape(-1),
          np.broadcast_to(c, blocks.shape).reshape(-1))),
        shape=(n * b, n * b))
    M.sum_duplicates()
    return M


def pcg_iters(A, rhs, M_apply, rtol=1e-8, maxiter=2000):
    """Plain PCG, counting iterations to ||r|| <= rtol*||b||."""
    x = np.zeros_like(rhs)
    r = rhs - A @ x
    z = M_apply(r)
    p = z.copy()
    rz = float(r @ z)
    nb = float(np.linalg.norm(rhs))
    for k in range(maxiter):
        if np.linalg.norm(r) <= rtol * nb:
            return k
        Ap = A @ p
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = M_apply(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return maxiter


def cheb_apply_factory(A, degree=3, eig_ratio=30.0):
    """solver/poly.py::ChebyshevPrecond semantics with scipy ops."""
    d = np.asarray(A.diagonal())
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    rng = np.random.RandomState(0)
    v = rng.rand(A.shape[0])
    for _ in range(12):
        w = inv_d * (A @ v)
        v = w / np.linalg.norm(w)
    w = inv_d * (A @ v)
    lmax = 1.05 * float(v @ w) / float(v @ v)
    lmin = lmax / eig_ratio
    theta, delta = (lmax + lmin) / 2, (lmax - lmin) / 2

    def apply(r):
        sigma = theta / delta
        rho = 1.0 / sigma
        pr = inv_d * r
        x = pr / theta
        dvec = x
        for _ in range(1, degree):
            res = pr - inv_d * (A @ x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            dvec = (rho_new * rho) * dvec + (2.0 * rho_new / delta) * res
            x = x + dvec
            rho = rho_new
        return x

    return apply


def ic0(A):
    """True IC(0): exact incomplete Cholesky on A's lower-triangle
    pattern (== ILU(0) for SPD symmetric-pattern A up to scaling).
    Sequential by definition — which is exactly the point of this
    experiment.  Returns L (csr) or None on breakdown."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, idx, dat = A.indptr, A.indices, A.data
    Lrows = [dict() for _ in range(n)]
    diag = np.zeros(n)
    for i in range(n):
        Li = Lrows[i]
        s = indptr[i]
        e = indptr[i + 1]
        for k in range(s, e):
            j = idx[k]
            if j > i:
                continue
            a = dat[k]
            Lj = Lrows[j]
            # sum over common columns < j
            acc = 0.0
            if len(Li) < len(Lj):
                for c, v in Li.items():
                    if c < j:
                        w = Lj.get(c)
                        if w is not None:
                            acc += v * w
            else:
                for c, w in Lj.items():
                    if c < j:
                        v = Li.get(c)
                        if v is not None:
                            acc += v * w
            if j == i:
                val = a - acc
                if val <= 0:
                    return None
                diag[i] = np.sqrt(val)
                Li[i] = diag[i]
            else:
                Li[j] = (a - acc) / diag[j]
    rows, colsL, vals = [], [], []
    for i in range(n):
        for c, v in Lrows[i].items():
            rows.append(i)
            colsL.append(c)
            vals.append(v)
    return sp.csr_matrix((vals, (rows, colsL)), shape=(n, n))


def level_depth(L):
    """Longest dependency chain of a lower-triangular solve (the number
    of sequential device steps a level-scheduled device solve needs)."""
    L = L.tocsr()
    n = L.shape[0]
    lvl = np.zeros(n, np.int64)
    indptr, idx = L.indptr, L.indices
    for i in range(n):
        m = 0
        for k in range(indptr[i], indptr[i + 1]):
            j = idx[k]
            if j < i and lvl[j] >= m:
                m = lvl[j] + 1
        lvl[i] = m
    return int(lvl.max()) + 1


def systems():
    from arcanefem_tpu.fem.bcs import dtype_safe_penalty
    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh
    from arcanefem_tpu.models.elasticity import element_blocks, lame
    from arcanefem_tpu.ops import elements

    out = []
    # 1e12, not 1e30: SuperLU pivoting/scaling misbehaves at 1e30
    pen = dtype_safe_penalty(1e12, np.float64)

    def poisson(mesh, name):
        prob = FemProblem(mesh, ndof=1, dtype=np.float64)
        A = prob.assemble_matrix(
            lambda ct, xyz: elements.stiffness(ct, xyz))
        Ac = csr_of(A).tolil()
        bnodes = np.unique(np.concatenate(
            [c.ravel() for c in mesh.boundary_faces().values()]))
        for i in bnodes:
            Ac[i, i] = Ac[i, i] + pen
        rhs = np.ones(mesh.n_nodes)
        rhs[bnodes] = 0.0
        out.append((name, Ac.tocsr(), rhs))

    poisson(rect_tria_mesh(90, 90), "poisson2d_8k")
    poisson(box_tetra_mesh(22, 22, 22), "poisson3d_11k")

    mesh = rect_tria_mesh(50, 50)
    prob = FemProblem(mesh, ndof=2, dtype=np.float64)
    lam, mu = lame(E=21e5, nu=0.28)
    A = prob.assemble_matrix(
        lambda ct, xyz: element_blocks(ct, xyz, lam, mu))
    Ac = csr_of(A).tolil()
    left = np.flatnonzero(mesh.coords[:, 0] < 1e-12)
    for i in np.concatenate([2 * left, 2 * left + 1]):
        Ac[i, i] = Ac[i, i] + pen
    rhs = np.zeros(2 * mesh.n_nodes)
    rhs[1::2] = -1.0
    rhs[2 * left] = 0.0
    rhs[2 * left + 1] = 0.0
    out.append(("elasticity2d_5k", Ac.tocsr(), rhs))
    return out


def main():
    results = []
    for name, A, rhs in systems():
        n = A.shape[0]
        d = np.asarray(A.diagonal())
        inv_d = 1.0 / d
        row = {"system": name, "n": n, "nnz": A.nnz}
        row["jacobi"] = pcg_iters(A, rhs, lambda r: inv_d * r)
        row["cheb3"] = pcg_iters(A, rhs, cheb_apply_factory(A, 3))
        L = ic0(A)
        if L is not None:
            Lc = L.tocsr()
            Uc = L.T.tocsr()

            def ic_apply(r, Lc=Lc, Uc=Uc):
                y = spla.spsolve_triangular(Lc, r, lower=True)
                return spla.spsolve_triangular(Uc, y, lower=False)

            row["ic0_iters"] = pcg_iters(A, rhs, ic_apply)
            row["ic0_depth"] = level_depth(Lc)
        else:
            row["ic0_iters"] = None
            row["ic0_error"] = "breakdown (non-positive pivot)"
        try:
            # a STRONGER-than-reference ILUT (pivoted, fill 10x): the
            # upper bound of the incomplete-factorization class; note its
            # M is not exactly symmetric (pivoting) — counts indicative
            ilut = spla.spilu(A.tocsc(), drop_tol=1e-4, fill_factor=10.0)
            row["ilut_iters"] = pcg_iters(A, rhs, ilut.solve)
            row["ilut_depth"] = level_depth(sp.tril(ilut.L.tocsr()))
        except Exception as e:
            row["ilut_iters"] = None
            row["ilut_error"] = repr(e)
        print(json.dumps(row), flush=True)
        results.append(row)
    os.makedirs(".cache/queue_results", exist_ok=True)
    with open(".cache/queue_results/ilu_decision.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
