"""FEM patch tests: exact reproduction of polynomial solutions.

The classical correctness gate: with Dirichlet data from a global linear
(P1) field and zero source, the discrete solution must equal that field to
machine precision on any mesh — exercising assembly, BC enforcement, and
the solver end-to-end independent of golden files.
"""

import numpy as np
import pytest

from arcanefem_tpu.fem.bcs import BoundaryConditions
from arcanefem_tpu.fem.problem import FemProblem
from arcanefem_tpu.mesh.core import read_msh
from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu.ops import elements
from arcanefem_tpu.solver.linear_system import SolverOptions


def _patch_poisson(mesh, lin):
    prob = FemProblem(mesh, ndof=1, dtype=np.float64)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    system = prob.new_system(A, SolverOptions(rtol=1e-13, max_iter=5000))
    bnodes = np.unique(
        np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    )
    vals = lin(mesh.coords[bnodes])
    prob.apply_dirichlet(system, prob.dof_ids(bnodes), vals, "RowColumnElimination")
    x, _ = system.solve()
    np.testing.assert_allclose(
        np.asarray(x), lin(mesh.coords), rtol=1e-8, atol=1e-10
    )


def test_patch_poisson_2d_unstructured(reference_dir):
    mesh = read_msh(f"{reference_dir}/meshes/msh/circle_cut.msh")
    _patch_poisson(mesh, lambda c: 0.3 * c[:, 0] - 1.7 * c[:, 1] + 0.5)


def test_patch_poisson_3d():
    mesh = box_tetra_mesh(5, 4, 6)
    _patch_poisson(
        mesh, lambda c: 2.0 * c[:, 0] + 0.7 * c[:, 1] - 1.1 * c[:, 2] + 3.0
    )


def test_patch_elasticity_2d():
    """Linear displacement field reproduced exactly (constant strain)."""
    from arcanefem_tpu.models.elasticity import element_blocks, lame

    mesh = rect_tria_mesh(7, 5)
    prob = FemProblem(mesh, ndof=2, dtype=np.float64)
    lam, mu2 = lame(3.0e5, 0.3)
    A = prob.assemble_matrix(lambda ct, xyz: element_blocks(ct, xyz, lam, mu2))
    system = prob.new_system(A, SolverOptions(rtol=1e-13, max_iter=5000))

    def lin(c):
        return np.stack(
            [1e-3 * c[:, 0] + 2e-4 * c[:, 1], -3e-4 * c[:, 0] + 5e-4 * c[:, 1]],
            axis=1,
        )

    bnodes = np.unique(
        np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    )
    vals = lin(mesh.coords[bnodes])
    for comp in range(2):
        prob.apply_dirichlet(
            system, prob.dof_ids(bnodes, comp), vals[:, comp],
            "RowColumnElimination",
        )
    x, _ = system.solve()
    got = np.asarray(x).reshape(-1, 2)
    np.testing.assert_allclose(got, lin(mesh.coords), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("ct_mesh", ["tria3", "tetra4"])
def test_patch_iso_quadrature_matches(ct_mesh):
    """Isoparametric assembly reproduces the patch test too (passmo path)."""
    import jax.numpy as jnp

    from arcanefem_tpu.ops import quadrature as Q

    mesh = rect_tria_mesh(5, 4) if ct_mesh == "tria3" else box_tetra_mesh(3, 3, 3)
    dim = 2 if ct_mesh == "tria3" else 3
    prob = FemProblem(mesh, ndof=dim, dtype=np.float64)
    A = prob.assemble_matrix(
        lambda ct, xyz: Q.stiffness_blocks_iso(ct, xyz, 2.0, 1.0, dim)
    )
    system = prob.new_system(A, SolverOptions(rtol=1e-13, max_iter=5000))

    rng = np.random.RandomState(0)
    G = 1e-3 * rng.rand(dim, dim)

    def lin(c):
        return c[:, :dim] @ G.T

    bnodes = np.unique(
        np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    )
    vals = lin(mesh.coords[bnodes])
    for comp in range(dim):
        prob.apply_dirichlet(
            system, prob.dof_ids(bnodes, comp), vals[:, comp],
            "RowColumnElimination",
        )
    x, _ = system.solve()
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1, dim), lin(mesh.coords), rtol=1e-7, atol=1e-11
    )


# --- quadratic (P2) patch tests -------------------------------------------
#
# P2 elements must reproduce harmonic QUADRATIC fields exactly: Dirichlet
# data from the field on the whole boundary (incl. midside nodes), zero
# source, iso quadrature assembly (ops/elements.stiffness_iso).


def test_patch_quadratic_tria6():
    from arcanefem_tpu.mesh.generate import quadratize

    mesh = quadratize(rect_tria_mesh(6, 5))
    _patch_poisson(mesh, lambda c: c[:, 0] ** 2 - c[:, 1] ** 2 + 0.3 * c[:, 0])


def test_patch_quadratic_tetra10():
    from arcanefem_tpu.mesh.generate import quadratize

    mesh = quadratize(box_tetra_mesh(3, 3, 4))
    _patch_poisson(
        mesh,
        lambda c: c[:, 0] * c[:, 1]
        + c[:, 1] * c[:, 2]
        + c[:, 0] ** 2
        - c[:, 2] ** 2,
    )


def test_quadratize_geometry():
    """Midside nodes sit at edge midpoints; counts follow Euler's formula."""
    from arcanefem_tpu.mesh.generate import quadratize

    m = rect_tria_mesh(4, 3)
    q = quadratize(m)
    t6 = q.cells["tria6"]
    assert t6.shape == (m.cells["tria3"].shape[0], 6)
    # corner block preserved
    np.testing.assert_array_equal(t6[:, :3], m.cells["tria3"])
    # midside 3 = midpoint of corners (0,1), 4=(1,2), 5=(2,0)
    for k, (a, b) in enumerate([(0, 1), (1, 2), (2, 0)]):
        np.testing.assert_allclose(
            q.coords[t6[:, 3 + k]],
            0.5 * (q.coords[t6[:, a]] + q.coords[t6[:, b]]),
        )
    # boundary faces became line3 and their midpoints are on the boundary
    for g, types in q.face_groups.items():
        assert set(types) == {"line3"}


@pytest.mark.parametrize("kind", ["tria6", "tetra10"])
def test_patch_elasticity_quadratic(kind):
    """Quadratic elements, vector blocks (passmo iso path): linear
    displacement reproduced exactly through midside nodes too."""
    import jax.numpy as jnp  # noqa: F401

    from arcanefem_tpu.mesh.generate import quadratize
    from arcanefem_tpu.ops import quadrature as Q

    mesh = quadratize(
        rect_tria_mesh(4, 3) if kind == "tria6" else box_tetra_mesh(2, 2, 3)
    )
    dim = 2 if kind == "tria6" else 3
    assert set(mesh.cells) == {kind}
    prob = FemProblem(mesh, ndof=dim, dtype=np.float64)
    A = prob.assemble_matrix(
        lambda ct, xyz: Q.stiffness_blocks_iso(ct, xyz, 2.0, 1.0, dim)
    )
    system = prob.new_system(A, SolverOptions(rtol=1e-13, max_iter=8000))

    rng = np.random.RandomState(1)
    G = 1e-3 * rng.rand(dim, dim)

    def lin(c):
        return c[:, :dim] @ G.T

    bnodes = np.unique(
        np.concatenate([c.ravel() for c in mesh.boundary_faces().values()])
    )
    vals = lin(mesh.coords[bnodes])
    for comp in range(dim):
        prob.apply_dirichlet(
            system, prob.dof_ids(bnodes, comp), vals[:, comp],
            "RowColumnElimination",
        )
    x, _ = system.solve()
    got = np.asarray(x).reshape(-1, dim)
    np.testing.assert_allclose(got, lin(mesh.coords), rtol=1e-7, atol=1e-11)
