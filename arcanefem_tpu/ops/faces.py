"""General boundary-face operations: Gauss geometry on embedded faces,
outward local frames, and boundary-cell lookup.

JAX counterpart of the reference's face-side FEM helpers used by
passmo's paraxial/traction machinery:

* surface Gauss integration of face shape functions — the role of
  `cell_fem.getGaussData(face, ...)` + `_computeJacobian` on faces
  (modules/passmo/ElastodynamicModule.cc:2157-2170, 1347-1384: for a face
  the "jacobian" is the surface measure scale at the Gauss point);
* the per-face local referential (e1,e2,e3) with outward normal — the role
  of `ArcaneFemFunctions::MeshOperation::dirVectors`
  (femutils/ArcaneFemFunctions.h:382-430), where Arcane's
  `isSubDomainBoundaryOutside` orientation is recovered here from the
  adjacent-cell centroid;
* the face -> unique adjacent cell map — the role of `face.boundaryCell()`
  (used for inner-material paraxial defaults,
  modules/passmo/ElastodynamicModule.cc:838-843).

Everything batched: one einsum chain per (face-type bucket), host NumPy for
the once-per-mesh adjacency tables.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import quadrature as Q


def face_gauss(face_type: str, xyz: jnp.ndarray, ninteg: int = 2):
    """Batched surface-Gauss data for faces embedded in ambient space.

    xyz: (nf, nfn, 3).  Returns (N (ng, nfn) numpy const, wdet (ng, nf))
    with wdet = w_g * sqrt(det(J Jᵀ)) — the length (edge) or area (face)
    jacobian at each Gauss point, valid for curved quadratic faces too.
    """
    N, dN = Q.shape_tables(face_type, ninteg)
    _, w = Q.rule(face_type, ninteg)
    dtype = np.asarray(xyz).dtype
    dNj = jnp.asarray(dN.astype(dtype))
    J = jnp.einsum("gnr,cnd->gcrd", dNj, xyz)  # (ng, nf, rdim, 3)
    G = jnp.einsum("gcrd,gcsd->gcrs", J, J)  # Gram (ng, nf, rdim, rdim)
    wdet = jnp.sqrt(jnp.linalg.det(G)) * jnp.asarray(w.astype(dtype))[:, None]
    return N, wdet


def face_mass(face_type: str, xyz: jnp.ndarray, ninteg: int = 2) -> jnp.ndarray:
    """Consistent face mass matrix ∫_Γ φi φj dΓ -> (nf, nfn, nfn)."""
    N, wdet = face_gauss(face_type, xyz, ninteg)
    Nj = jnp.asarray(N.astype(np.asarray(xyz).dtype))
    return jnp.einsum("gc,gi,gj->cij", wdet, Nj, Nj)


def face_load(face_type: str, xyz: jnp.ndarray, ninteg: int = 2) -> jnp.ndarray:
    """Consistent nodal load weights ∫_Γ φi dΓ -> (nf, nfn).

    (The reference lumps tractions equally per node — `computeFacLengthOrArea`
    / nb_nodes, ElastodynamicModule.cc:2317-2334 — which is inconsistent for
    quadratic faces; this is the consistent Gauss version.)
    """
    N, wdet = face_gauss(face_type, xyz, ninteg)
    Nj = jnp.asarray(N.astype(np.asarray(xyz).dtype))
    return jnp.einsum("gc,gi->ci", wdet, Nj)


def _adjacency_table(mesh, nfn: int):
    """sorted-node-key -> (cell_type, row) for every nfn-node cell facet."""
    from ..mesh.core import _FACES_OF

    table: dict[tuple, tuple[str, int]] = {}
    for ctype, cells in mesh.cells.items():
        for loc in _FACES_OF.get(ctype, []):
            if len(loc) != nfn:
                continue
            facets = np.sort(cells[:, loc], axis=1)
            for row, f in enumerate(map(tuple, facets)):
                # boundary facets are seen once; for interior either cell
                # serves the centroid test
                table[f] = (ctype, row)
    return table


def boundary_cells(mesh, conn: np.ndarray):
    """Per-face unique adjacent cell as (cell_type, row) — face.boundaryCell().

    Returns a list of length nf; entries are None when no volume cell of the
    mesh contains the face (e.g. standalone surface meshes).
    """
    table = _adjacency_table(mesh, conn.shape[1])
    return [table.get(tuple(np.sort(f))) for f in conn]


_CORNERS = {"line2": 2, "line3": 2, "tria3": 3, "tria6": 3,
            "quad4": 4, "quad8": 4}


def face_frames(mesh, face_type: str, conn: np.ndarray):
    """Constant per-face local frame (e1, e2, e3), each (nf, 3).

    Mirrors dirVectors (ArcaneFemFunctions.h:382-430): e1 = first edge
    direction; 2D -> e2 = outward normal, e3 = 0; 3D -> e3 = outward normal,
    e2 = e3×e1.  "Outward" is resolved from the adjacent cell centroid
    (the reference flips the first edge via isSubDomainBoundaryOutside and
    builds the normal from it).  Quadratic faces use their corner nodes —
    the same flat-face frame the reference computes from nodes 0/1/2.
    """
    xyz = mesh.coords[conn]  # (nf, nfn, 3)
    adj = boundary_cells(mesh, conn)
    cell_cent = np.empty((conn.shape[0], 3))
    for k, a in enumerate(adj):
        if a is None:
            # no adjacent volume cell: fall back to the face centroid so the
            # sign test below is a no-op (normal kept as constructed)
            cell_cent[k] = xyz[k, : _CORNERS[face_type]].mean(axis=0)
        else:
            ctype, row = a
            cell_cent[k] = mesh.coords[mesh.cells[ctype][row]].mean(axis=0)
    fc = xyz[:, : _CORNERS[face_type]].mean(axis=1)  # corner centroid
    e1 = xyz[:, 1] - xyz[:, 0]
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    if face_type in ("line2", "line3"):
        n = np.stack([e1[:, 1], -e1[:, 0], np.zeros(len(e1))], axis=1)
        flip = np.einsum("fd,fd->f", n, fc - cell_cent) < 0
        n[flip] *= -1.0
        return e1, n, np.zeros_like(n)
    n = np.cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flip = np.einsum("fd,fd->f", n, fc - cell_cent) < 0
    n[flip] *= -1.0
    e2 = np.cross(n, e1)
    return e1, e2, n


def outward_normals(mesh, face_type: str, conn: np.ndarray) -> np.ndarray:
    """(nf, 3) outward unit normals (e2 in 2D, e3 in 3D)."""
    e1, e2, e3 = face_frames(mesh, face_type, conn)
    return e2 if face_type in ("line2", "line3") else e3


def paraxial_direction_matrix(
    normals: np.ndarray, rho, cs, cp, ndof: int
) -> np.ndarray:
    """P(n) = ρ·(cs·(I − n⊗n) + cp·n⊗n) restricted to ndof components.

    The directional impedance matrix of the 0th-order paraxial condition:
    ROTᵀ·diag(ρ·[cs,cs,cp])·ROT with ROT rows (e1,e2,e3) collapses to this
    normal-only form (modules/passmo/ElastodynamicModule.cc:1662-1694 builds
    the same aij = ρcs·δ + ρ(cp−cs)·n_l n_ll; quadratic in n, so face
    orientation does not matter).  rho/cs/cp: scalars or (nf,) arrays.
    """
    nf = normals.shape[0]
    rho = np.broadcast_to(np.asarray(rho, np.float64), (nf,))
    cs = np.broadcast_to(np.asarray(cs, np.float64), (nf,))
    cp = np.broadcast_to(np.asarray(cp, np.float64), (nf,))
    n = normals[:, :ndof]
    eye = np.eye(ndof)
    nxn = np.einsum("fa,fb->fab", n, n)
    return (rho * cs)[:, None, None] * (eye[None] - nxn) + (
        rho * cp
    )[:, None, None] * nxn
