"""Supernode node ordering (sparse/supernode.py): a permutation that
leaves the physics unchanged."""

import numpy as np

from arcanefem_tpu.mesh.generate import box_tetra_mesh
from arcanefem_tpu.sparse.supernode import supernode_order
from arcanefem_tpu.sparse.topology import build_topology
from arcanefem_tpu.utils.ordering import renumber_mesh


def test_supernode_order_is_permutation():
    mesh = box_tetra_mesh(6, 5, 4)
    t0 = build_topology(mesh.n_nodes, mesh.cells)
    perm = supernode_order(t0, mesh.coords)
    assert sorted(perm) == list(range(mesh.n_nodes))


def test_order_keeps_solution_invariant():
    """Supernode renumbering must not change the physics."""
    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu.models import poisson

    bcs = BoundaryConditions(
        dirichlet=[DirichletBC("xmin", 0.0), DirichletBC("xmax", 1.0)]
    )
    cfg = poisson.PoissonConfig(f=1.0, bcs=bcs)
    mesh = box_tetra_mesh(6, 5, 4)
    r0 = poisson.solve(mesh, cfg)
    t0 = build_topology(mesh.n_nodes, mesh.cells)
    perm = supernode_order(t0, mesh.coords)
    r1 = poisson.solve(renumber_mesh(mesh, perm), cfg)
    np.testing.assert_allclose(r0.u[perm], r1.u, rtol=1e-9, atol=1e-12)
