"""The two benchmark problems, built cold from a seed.

``bench.py`` and ``chip_smoke.py`` drive the same pipelines (BASELINE.md
describes the reference's benchmark they model):

* **unstructured** — the reference's north-star ``sphere_cut`` tetra mesh
  (Delaunay of a seeded point cloud + red refinement), RCM then supernode
  node order, native topology, lane-major segment-sum assembly, penalty
  Dirichlet (Cut = 0, sphere = 1), unit source, SA-AMG (Chebyshev(2),
  theta 0.03) preconditioned CG.
* **structured** — an n³ Kuhn-tet box with jittered nodes, DIA slice-add
  assembly, penalty Dirichlet (xmin = 0, xmax = 1), unit source,
  geometric-multigrid preconditioned CG, all in one jitted step.

Nothing here reads or writes a cache: every call rebuilds from the seed,
so a fresh checkout pays exactly what these functions report.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .mesh.core import Mesh
from .sparse.bell import BellMatrix
from .sparse.topology import Topology, build_topology

# penalty Dirichlet value: large enough to pin the boundary rows, small
# enough that P·g and the penalty diagonal stay exact in f32
PENALTY = 1.0e12
# SA-AMG settings of the unstructured problem: Chebyshev(2) level smoother
# and strength threshold 0.03 (tools/conv_tune.py: fewer iterations AND a
# lower operator complexity than 0.08 on this geometry)
AMG_OPTIONS = dict(smoother="chebyshev", cheb_deg=2, theta=0.03)


def sphere_cut_mesh(h: float, refine: int, seed: int = 0):
    """(mesh, topology, setup seconds by phase) of the sphere_cut problem.

    Node order: RCM, then the supernode brick order (sparse/supernode.py);
    cells sorted by min node (utils/ordering.renumber_mesh).
    """
    from .mesh.unstructured import refine_tetra, sphere_cut_tetra_mesh
    from .sparse.supernode import supernode_order
    from .utils.ordering import rcm_order, renumber_mesh

    times = {}
    t0 = time.perf_counter()
    mesh = sphere_cut_tetra_mesh(h=h, seed=seed)
    for _ in range(refine):
        mesh = refine_tetra(mesh)
    times["mesh_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    topo = build_topology(mesh.n_nodes, mesh.cells)
    mesh = renumber_mesh(mesh, rcm_order(mesh.n_nodes, topo.row_ptr,
                                         topo.csr_cols))
    topo = build_topology(mesh.n_nodes, mesh.cells)
    mesh = renumber_mesh(mesh, supernode_order(topo, mesh.coords))
    times["order_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    topo = build_topology(mesh.n_nodes, mesh.cells)
    times["topology_s"] = time.perf_counter() - t0
    return mesh, topo, times


@dataclass
class PenaltySystem:
    """Host side of a penalty-Dirichlet Poisson system (float64)."""

    mask: np.ndarray  # (n,) bool, Dirichlet rows
    x0: np.ndarray  # (n,) warm start: the Dirichlet values, 0 elsewhere
    rhs: np.ndarray  # (n,) source load, P·g on Dirichlet rows


def sphere_cut_system(mesh: Mesh, penalty: float = PENALTY) -> PenaltySystem:
    """Cut = 0, sphere = 1 penalty Dirichlet, unit source f = 1."""
    n = mesh.n_nodes
    conn = np.asarray(mesh.cells["tetra4"])
    mask = np.zeros(n, bool)
    mask[np.unique(mesh.face_groups["Cut"]["tria3"])] = True
    sph = np.unique(mesh.face_groups["sphere"]["tria3"])
    mask[sph] = True
    g = np.zeros(n)
    g[sph] = 1.0
    pc = mesh.coords[conn]
    vv = pc[:, 1:] - pc[:, :1]
    vols = np.abs(np.einsum(
        "ij,ij->i", np.cross(vv[:, 0], vv[:, 1]), vv[:, 2])) / 6.0
    rhs = np.bincount(conn.reshape(-1), np.repeat(vols / 4.0, 4),
                      minlength=n)
    return PenaltySystem(mask=mask, x0=np.where(mask, g, 0.0),
                         rhs=np.where(mask, penalty * g, rhs))


def penalized_values(values: np.ndarray, topo: Topology, mask: np.ndarray,
                     penalty: float = PENALTY) -> np.ndarray:
    """Flat host copy of assembled (n, W) values with diag := P on mask."""
    flat = np.asarray(values).reshape(-1).copy()
    flat[np.asarray(topo.diag_slot)[mask]] = penalty
    return flat


def bell_matrix(flat: np.ndarray, topo: Topology, dtype) -> BellMatrix:
    """Scalar BellMatrix on the device from flat host values."""
    return BellMatrix(
        values=jnp.asarray(flat.reshape(topo.n_nodes, topo.width, 1, 1)
                           .astype(dtype)),
        topo=topo, block=1, cols=jnp.asarray(topo.ell_cols),
    )


@dataclass
class StructuredProblem:
    box: object  # mesh.structured.StructuredBox
    coords: np.ndarray  # (nx+1, ny+1, nz+1, 3) float32, jittered
    mask: np.ndarray  # (n,) bool, xmin/xmax Dirichlet rows
    g: np.ndarray  # (n,) float32 Dirichlet values (1 on xmax)


def structured_problem(n: int, seed: int = 0) -> StructuredProblem:
    from .mesh.structured import StructuredBox

    box = StructuredBox(n, n, n)
    g = np.zeros(box.n_nodes, np.float32)
    g[box.boundary_mask(("xmax",))] = 1.0
    return StructuredProblem(
        box=box, coords=box.grid_coords(np.float32, jitter=0.1, seed=seed),
        mask=box.boundary_mask(("xmin", "xmax")), g=g)


def structured_solver(p: StructuredProblem, rtol: float, nu: int = 1,
                      penalty: float = PENALTY):
    """jitted coords -> (x, iterations, monitored residual): assembly,
    source, penalty BCs, geometric-MG hierarchy and PCG in one step (the
    hierarchy is rebuilt inside the step, as Hypre's setup is inside its
    solve timer)."""
    from .mesh.structured import apply_penalty_dirichlet
    from .solver.iterative import pcg
    from .solver.multigrid import build_mg

    box, mask_np = p.box, p.mask
    mask, g = jnp.asarray(p.mask), jnp.asarray(p.g)

    @jax.jit
    def solve(c3d):
        A = box.assemble_stiffness(c3d)
        rhs = box.source_rhs(c3d, 1.0)
        A, rhs = apply_penalty_dirichlet(A, rhs, mask, g, penalty)
        M = build_mg(box, c3d, mask_np, penalty, nu=nu)
        x0 = jnp.where(mask, g, 0.0)
        return pcg(A, rhs, M, x0, rtol, 0.0, 5000, use_precise_dot=True)

    return solve
