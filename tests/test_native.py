"""Native C++ topology builder vs the NumPy reference implementation."""

import numpy as np
import pytest

from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu.sparse.topology import build_topology
from arcanefem_tpu.utils.native import library


@pytest.mark.skipif(library() is None, reason="native library unavailable")
@pytest.mark.parametrize("mesh,pad", [
    (rect_tria_mesh(9, 7), 1),
    (box_tetra_mesh(5, 4, 3), 8),
])
def test_native_matches_numpy(mesh, pad):
    tn = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=pad, use_native=True)
    tp = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=pad, use_native=False)
    assert tn.width == tp.width and tn.nnz == tp.nnz
    np.testing.assert_array_equal(tn.ell_cols, tp.ell_cols)
    np.testing.assert_array_equal(tn.ell_valid, tp.ell_valid)
    np.testing.assert_array_equal(tn.row_ptr, tp.row_ptr)
    np.testing.assert_array_equal(tn.csr_cols, tp.csr_cols)
    np.testing.assert_array_equal(tn.csr_to_ell, tp.csr_to_ell)
    np.testing.assert_array_equal(tn.diag_slot, tp.diag_slot)
    for k in tn.slot_maps:
        np.testing.assert_array_equal(tn.slot_maps[k], tp.slot_maps[k])


@pytest.mark.skipif(library() is None, reason="native library unavailable")
def test_native_mixed_buckets(reference_dir):
    """Mixed tria+quad mesh (two buckets) through the native path."""
    from arcanefem_tpu.mesh.core import read_msh

    mesh = read_msh(f"{reference_dir}/meshes/msh/bar_hybrid_quad_tria.msh")
    tn = build_topology(mesh.n_nodes, mesh.cells, use_native=True)
    tp = build_topology(mesh.n_nodes, mesh.cells, use_native=False)
    assert tn.nnz == tp.nnz
    for k in tn.slot_maps:
        np.testing.assert_array_equal(tn.slot_maps[k], tp.slot_maps[k])


def test_native_amg_strength_filter_smooth_p_parity():
    """amg_setup.cpp vs the scipy formulas on a random SPD-ish CSR."""
    import scipy.sparse as sp

    from arcanefem_tpu.utils.native import (
        amg_smooth_p_native,
        amg_strength_filter_native,
    )

    rng = np.random.RandomState(3)
    n = 400
    A = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    A = (A + A.T).tocsr()
    A = (A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    theta = 0.05
    nat = amg_strength_filter_native(A.indptr, A.indices, A.data, theta)
    assert nat is not None, "native library unavailable"
    s_indptr, s_cols, af_data, ddf = nat

    # scipy reference: strength pattern
    d = np.asarray(A.diagonal())
    co = A.tocoo()
    scale = np.sqrt(np.abs(d[co.row] * d[co.col])) + 1e-300
    keep = (np.abs(co.data) >= theta * scale) & (co.row != co.col)
    S_ref = sp.csr_matrix(
        (np.ones(int(keep.sum())), (co.row[keep], co.col[keep])),
        shape=A.shape)
    S_nat = sp.csr_matrix(
        (np.ones(len(s_cols)), s_cols, s_indptr), shape=A.shape)
    assert (S_ref != S_nat).nnz == 0

    # scipy reference: filtered operator
    af_ref = np.where(keep | (co.row == co.col), co.data, 0.0)
    drop = np.zeros(n)
    np.add.at(drop, co.row, co.data - af_ref)
    Af_ref = sp.csr_matrix((af_ref, (co.row, co.col)), shape=A.shape) \
        + sp.diags(drop)
    Af_nat = sp.csr_matrix((af_data, A.indices, A.indptr), shape=A.shape)
    assert abs(Af_ref - Af_nat).max() < 1e-12
    np.testing.assert_allclose(ddf, np.asarray(Af_nat.diagonal()),
                               rtol=0, atol=1e-12)

    # smoothP + truncate parity
    from arcanefem_tpu.solver.amg import _aggregate, truncate_rows

    agg, na = _aggregate(S_ref, n)
    c = 4.0 / 3.0 / 2.5
    nat_p = amg_smooth_p_native(A.indptr, A.indices, af_data, ddf, c,
                                agg, na, 8, 0.05, rescale=True)
    assert nat_p is not None
    p_indptr, p_cols, p_data = nat_p
    P_nat = sp.csr_matrix((p_data, p_cols, p_indptr), shape=(n, na))
    sel = agg >= 0
    T = sp.csr_matrix(
        (np.ones(int(sel.sum())), (np.arange(n)[sel], agg[sel])),
        shape=(n, na))
    Dinvf = sp.diags(1.0 / np.where(ddf == 0, 1.0, ddf))
    P_ref = (sp.identity(n, format="csr") - c * (Dinvf @ Af_ref)) @ T
    P_ref = truncate_rows(P_ref.tocsr(), kmax=8, rel=0.05, rescale=True)
    assert P_ref.shape == P_nat.shape
    assert abs(P_ref - P_nat).max() < 1e-12, \
        f"max dev {abs(P_ref - P_nat).max()}"
