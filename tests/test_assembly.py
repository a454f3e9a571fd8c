"""Assembly correctness: BELL segment-sum vs a dense NumPy reference.

The role of testlab's CROSS_VALIDATION (reference modules/testlab/
FemModule.cc:241-244): every sparse-format assembly must agree with a
straightforward dense accumulation.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from arcanefem_tpu.fem.problem import FemProblem
from arcanefem_tpu.mesh import read_msh, rect_tria_mesh
from arcanefem_tpu.mesh.generate import box_tetra_mesh
from arcanefem_tpu.ops import elements
from arcanefem_tpu.sparse.topology import build_topology


def dense_assemble(n_nodes, conn, ke, ndof=1):
    ke = np.asarray(ke)
    n = n_nodes * ndof
    A = np.zeros((n, n))
    for c in range(conn.shape[0]):
        for i in range(conn.shape[1]):
            for j in range(conn.shape[1]):
                if ndof == 1:
                    A[conn[c, i], conn[c, j]] += ke[c, i, j]
                else:
                    for a in range(ndof):
                        for b in range(ndof):
                            A[conn[c, i] * ndof + a, conn[c, j] * ndof + b] += ke[
                                c, i, j, a, b
                            ]
    return A


def test_topology_symmetry(reference_dir):
    mesh = read_msh(f"{reference_dir}/meshes/msh/circle_cut.msh")
    topo = build_topology(mesh.n_nodes, mesh.cells)
    # node graph contains the diagonal and is symmetric
    rows = np.repeat(np.arange(mesh.n_nodes), np.diff(topo.row_ptr))
    pairs = set(zip(rows.tolist(), topo.csr_cols.tolist()))
    for i in range(mesh.n_nodes):
        assert (i, i) in pairs
    assert all((j, i) in pairs for (i, j) in pairs)


def test_scalar_assembly_matches_dense():
    mesh = rect_tria_mesh(5, 4)
    prob = FemProblem(mesh, ndof=1)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    conn = mesh.cells["tria3"]
    ke = elements.stiffness_tria3(jnp.asarray(mesh.coords)[jnp.asarray(conn)])
    ref = dense_assemble(mesh.n_nodes, conn, ke)
    np.testing.assert_allclose(np.asarray(A.todense()), ref, atol=1e-12)
    # spmv agrees with dense
    x = np.random.default_rng(0).normal(size=mesh.n_nodes)
    np.testing.assert_allclose(
        np.asarray(A.spmv(jnp.asarray(x))), ref @ x, atol=1e-12
    )
    # diagonal extraction
    np.testing.assert_allclose(np.asarray(A.diagonal()), np.diag(ref), atol=1e-13)


def test_block_assembly_matches_dense():
    mesh = rect_tria_mesh(3, 3)
    prob = FemProblem(mesh, ndof=2)
    lam, mu2 = 1.25, 2.3
    A = prob.assemble_matrix(
        lambda ct, xyz: elements.elasticity_tria3(xyz, lam, mu2)
    )
    conn = mesh.cells["tria3"]
    ke = elements.elasticity_tria3(
        jnp.asarray(mesh.coords)[jnp.asarray(conn)], lam, mu2
    )
    ref = dense_assemble(mesh.n_nodes, conn, ke, ndof=2)
    np.testing.assert_allclose(np.asarray(A.todense()), ref, atol=1e-12)
    x = np.random.default_rng(1).normal(size=2 * mesh.n_nodes)
    np.testing.assert_allclose(
        np.asarray(A.spmv(jnp.asarray(x))), ref @ x, atol=1e-12
    )
    # elasticity element matrix is symmetric
    np.testing.assert_allclose(ref, ref.T, atol=1e-12)


def test_stiffness_kernel_properties(reference_dir):
    # rows of the Laplacian element matrix sum to zero (constant in kernel)
    mesh = read_msh(f"{reference_dir}/meshes/msh/circle_cut.msh")
    xyz = jnp.asarray(mesh.coords)[jnp.asarray(mesh.cells["tria3"])]
    ke = elements.stiffness_tria3(xyz)
    np.testing.assert_allclose(np.asarray(ke.sum(axis=2)), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ke), np.asarray(ke).transpose(0, 2, 1), atol=1e-12)


def test_mass_matrix_total():
    mesh = rect_tria_mesh(4, 4, 2.0, 3.0)
    prob = FemProblem(mesh, ndof=1)
    M = prob.assemble_matrix(lambda ct, xyz: elements.mass(ct, xyz))
    ones = jnp.ones(mesh.n_nodes)
    # 1^T M 1 = domain area
    total = float(ones @ M.spmv(ones))
    assert np.isclose(total, 6.0)


def test_lane_assembler_matches_elements_path():
    """Lane-major tetra assembly == element-centric assembly (the
    cell-last layout used by the sphere_cut benchmark, ops/lane_assembly)."""
    import jax.numpy as jnp

    from arcanefem_tpu.mesh.generate import box_tetra_mesh
    from arcanefem_tpu.ops import elements
    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.sparse.topology import build_topology
    import jax

    mesh = box_tetra_mesh(6, 5, 4)
    topo = build_topology(mesh.n_nodes, mesh.cells)
    coords = jnp.asarray(mesh.coords.astype(np.float32))
    conn = mesh.cells["tetra4"]

    asm = TetraLaneAssembler(topo, conn)
    got = np.asarray(asm(coords))

    ke = elements.stiffness_tetra4(coords[jnp.asarray(conn)])
    ref = np.asarray(jax.ops.segment_sum(
        ke.reshape(-1), jnp.asarray(topo.slot_maps["tetra4"].reshape(-1)),
        num_segments=topo.n_slots,
    ).reshape(topo.n_nodes, topo.width))
    np.testing.assert_allclose(got, ref, rtol=5e-6, atol=1e-6)


def _sphere_cut_mesh():
    from arcanefem_tpu.mesh.unstructured import sphere_cut_tetra_mesh

    return sphere_cut_tetra_mesh(h=14.0)


@pytest.mark.parametrize("make_mesh", [
    partial(box_tetra_mesh, 5, 4, 3),
    partial(box_tetra_mesh, 3, 3, 3, 0.5, 2.0, 1.0),
    _sphere_cut_mesh,
], ids=["box", "box-aniso", "sphere_cut"])
def test_segsum_assembly_matches_numpy_reference(make_mesh):
    """The segment-sum (scatter-add) lane assembly, the benchmark's only
    assembly path, against chip_smoke's independent float64 numpy/scipy
    assembly at its f32 tolerance."""
    import jax.numpy as jnp

    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.sparse.topology import build_topology
    from chip_smoke import (
        ASM_TOL, bell_csr, reference_stiffness, row_scaled_error,
    )

    mesh = make_mesh()
    topo = build_topology(mesh.n_nodes, mesh.cells)
    conn = mesh.cells["tetra4"]
    c32 = mesh.coords.astype(np.float32)
    got = np.asarray(TetraLaneAssembler(topo, conn)(jnp.asarray(c32)))
    assert got.dtype == np.float32 and got.shape == (topo.n_nodes, topo.width)
    # padding slots stay exactly zero
    assert not got[~np.asarray(topo.ell_valid)].any()
    ref = reference_stiffness(c32.astype(np.float64), conn)
    gc = bell_csr(got, topo)
    assert np.array_equal(gc.indices, ref.indices)
    assert row_scaled_error(gc, ref) <= ASM_TOL

