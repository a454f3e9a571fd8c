"""FemProblem — shared per-module infrastructure.

This is the JAX counterpart of what every reference module repeats:
FemDoFsOnNodes numbering (femutils/FemDoFsOnNodes.cc:71-128: dof uid =
node_uid*ndof+i), sparsity setup (BSRFormat::computeSparsity), RHS builders
and boundary-condition application (femutils/ArcaneFemFunctions.h:824-1222
BoundaryConditions2D/3D).

Host-side (NumPy) work happens once at construction: topology, slot maps,
boundary-face orientation, group index arrays.  Everything per-solve is
jit-compatible JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..mesh.core import Mesh
from ..ops import elements, geometry
from ..sparse.bell import BellMatrix, assemble_bell
from ..sparse.topology import Topology, build_topology
from ..solver.linear_system import LinearSystem, SolverOptions

_FACE_MEASURE = {
    "line2": geometry.edge2_length,
    "tria3": geometry.tria3_area,
}
_FACE_NORMAL = {
    "line2": geometry.edge2_normal,
    "tria3": geometry.tria3_normal,
}


def orient_faces_outward(mesh: Mesh, conn: np.ndarray) -> np.ndarray:
    """Flip boundary faces so their normal points out of the domain.

    The reference gets this from Arcane's face orientation
    (`isSubDomainBoundaryOutside`, ArcaneFemFunctions.h:271-284); here we
    recover it from face-cell adjacency: the outward normal points away
    from the adjacent cell centroid.
    """
    nfn = conn.shape[1]
    # map sorted-face-key -> centroid of adjacent cell
    keys = {}
    for ctype, cells in mesh.cells.items():
        from ..mesh.core import _FACES_OF

        for loc in _FACES_OF.get(ctype, []):
            if len(loc) != nfn:
                continue
            faces = cells[:, loc]
            srt = np.sort(faces, axis=1)
            cent = mesh.coords[cells].mean(axis=1)
            for f, c in zip(map(tuple, srt), cent):
                keys[f] = c  # interior faces seen twice: either cell works
                # for boundary faces (seen once) this is the owner cell
    out = conn.copy()
    for k, face in enumerate(conn):
        key = tuple(np.sort(face))
        cell_cent = keys.get(key)
        if cell_cent is None:
            continue
        fc = mesh.coords[face]
        centroid = fc.mean(axis=0)
        if nfn == 2:
            d = fc[1] - fc[0]
            n = np.array([d[1], -d[0], 0.0])
        else:
            n = np.cross(fc[1] - fc[0], fc[2] - fc[0])
        if np.dot(n, centroid - cell_cent) < 0:
            out[k, 0], out[k, 1] = out[k, 1], out[k, 0]
    return out


@dataclass
class FemProblem:
    mesh: Mesh
    ndof: int = 1
    dtype: np.dtype = np.float64
    pad_width_to: int = 1

    topo: Topology = field(init=False)
    coords: jnp.ndarray = field(init=False)

    def __post_init__(self):
        self.topo = build_topology(
            self.mesh.n_nodes, self.mesh.cells, pad_width_to=self.pad_width_to
        )
        self.coords = jnp.asarray(self.mesh.coords.astype(self.dtype))
        self._oriented_faces: dict[str, dict[str, np.ndarray]] = {}

    # -- dof helpers --------------------------------------------------------
    @property
    def n_dofs(self) -> int:
        return self.mesh.n_nodes * self.ndof

    def dof_ids(self, nodes: np.ndarray, comp: int = 0) -> np.ndarray:
        """dof uid = node*ndof + comp (FemDoFsOnNodes.cc:86)."""
        return nodes.astype(np.int64) * self.ndof + comp

    def cell_xyz(self, cell_type: str) -> jnp.ndarray:
        conn = jnp.asarray(self.mesh.cells[cell_type])
        return self.coords[conn]

    def face_xyz(self, conn: np.ndarray) -> jnp.ndarray:
        return self.coords[jnp.asarray(conn)]

    # -- matrix assembly ------------------------------------------------------
    def assemble_matrix(
        self,
        element_fn: Callable[[str, jnp.ndarray], jnp.ndarray],
    ) -> BellMatrix:
        """element_fn(cell_type, xyz) -> (nc, npc, npc[, b, b]) blocks."""
        mats = {
            ctype: element_fn(ctype, self.cell_xyz(ctype))
            for ctype in self.mesh.cells
        }
        return assemble_bell(self.topo, mats, block=self.ndof, dtype=self.dtype)

    def stiffness_matrix(self, coef: float | jnp.ndarray = 1.0) -> BellMatrix:
        return self.assemble_matrix(
            lambda ct, xyz: coef * elements.stiffness(ct, xyz)
        )

    def add_face_matrix(
        self,
        A: BellMatrix,
        group: str,
        face_fn: Callable[[str, jnp.ndarray], jnp.ndarray],
        comp: int = 0,
    ) -> BellMatrix:
        """Add boundary-element matrices (e.g. convection h·∫uv on EDGE2,
        reference modules/heat/FemModule.cc:225-227; paraxial terms in
        soildynamics) into the assembled matrix.

        face_fn(ftype, xyz) -> (nf, nfn, nfn) scalar blocks added at
        component `comp`, or (nf, nfn, nfn, b, b) full blocks.
        """
        from ..sparse.topology import face_dof_slots

        flat = A.flat_values()
        for ftype, conn in self.mesh.face_groups[group].items():
            ke = face_fn(ftype, self.face_xyz(conn))
            nfn = conn.shape[1]
            rows = np.repeat(conn, nfn, axis=1).reshape(-1)
            cols = np.tile(conn, (1, nfn)).reshape(-1)
            slots = jnp.asarray(face_dof_slots(self.topo, rows, cols))
            if ke.ndim == 3:
                flat = flat.at[slots, comp, comp].add(ke.reshape(-1))
            else:
                flat = flat.at[slots].add(ke.reshape(-1, self.ndof, self.ndof))
        return A.with_values(flat)

    def new_system(self, matrix: BellMatrix, options: SolverOptions | None = None) -> LinearSystem:
        rhs = jnp.zeros(self.n_dofs, matrix.values.dtype)
        return LinearSystem(
            matrix=matrix, rhs=rhs, options=options or SolverOptions()
        )

    # -- RHS builders ---------------------------------------------------------
    def constant_source_rhs(
        self, qdot: float | jnp.ndarray, comp: int = 0
    ) -> jnp.ndarray:
        """rhs[node] += qdot * measure / npc over all cells
        (applyConstantSourceToRhs, ArcaneFemFunctions.h:845-855/1010-1021)."""
        rhs = jnp.zeros(self.n_dofs, self.dtype)
        for ctype, conn in self.mesh.cells.items():
            xyz = self.cell_xyz(ctype)
            meas = elements.measure(ctype, xyz)  # (nc,)
            npc = conn.shape[1]
            contrib = jnp.repeat(qdot * meas / npc, npc)
            dofs = jnp.asarray(self.dof_ids(conn.reshape(-1), comp))
            rhs = rhs.at[dofs].add(contrib)
        return rhs

    def vector_source_rhs(
        self, rhs: jnp.ndarray, f: tuple
    ) -> jnp.ndarray:
        """Body-force rhs[node*b+c] += f_c * measure / npc per cell
        (reference modules/elasticity/FemModule.cc:230-241); None = skip."""
        for ctype, conn in self.mesh.cells.items():
            xyz = self.cell_xyz(ctype)
            meas = elements.measure(ctype, xyz)
            npc = conn.shape[1]
            flat_nodes = conn.reshape(-1)
            for c, fc in enumerate(f):
                if fc is None or c >= self.ndof:
                    continue
                contrib = jnp.repeat(fc * meas / npc, npc)
                rhs = rhs.at[jnp.asarray(self.dof_ids(flat_nodes, c))].add(contrib)
        return rhs

    def traction_rhs(
        self, rhs: jnp.ndarray, group: str, t: tuple
    ) -> jnp.ndarray:
        """Traction rhs[node*b+c] += t_c * measure / n_face_nodes per face
        (reference modules/elasticity/FemModule.cc:246-272)."""
        for ftype, conn in self.mesh.face_groups[group].items():
            xyz = self.face_xyz(conn)
            meas = _FACE_MEASURE[ftype](xyz)
            nfn = conn.shape[1]
            flat_nodes = conn.reshape(-1)
            for c, tc in enumerate(t):
                if tc is None or c >= self.ndof:
                    continue
                contrib = jnp.repeat(tc * meas / nfn, nfn)
                rhs = rhs.at[jnp.asarray(self.dof_ids(flat_nodes, c))].add(contrib)
        return rhs

    def apply_dirichlet_vector(
        self,
        system: LinearSystem,
        nodes: np.ndarray,
        values: tuple,
        method: str = "Penalty",
        penalty: float = 1.0e30,
    ) -> None:
        """Per-component vector Dirichlet: component c is constrained only
        when values[c] is not None (the reference's NULL components,
        modules/elasticity/FemModule.cc:299-400)."""
        for c, v in enumerate(values):
            if v is None or c >= self.ndof:
                continue
            self.apply_dirichlet(
                system, self.dof_ids(nodes, c), v, method, penalty
            )

    def oriented_group(self, name: str) -> dict[str, np.ndarray]:
        """Outward-oriented face connectivity for a boundary group."""
        if name not in self._oriented_faces:
            self._oriented_faces[name] = {
                ftype: orient_faces_outward(self.mesh, conn)
                for ftype, conn in self.mesh.face_groups[name].items()
            }
        return self._oriented_faces[name]

    def neumann_rhs(
        self,
        rhs: jnp.ndarray,
        group: str,
        value: float | None = None,
        vector: tuple | None = None,
        comp: int = 0,
    ) -> jnp.ndarray:
        """applyNeumannToRhs (ArcaneFemFunctions.h:934-988 / 1062-1116):
        per boundary face, each node gets value*measure/n_face_nodes; for
        vector loads the value is n·v."""
        for ftype, conn in self.oriented_group(group).items():
            xyz = self.face_xyz(conn)
            meas = _FACE_MEASURE[ftype](xyz)
            if value is not None:
                per_face = value * meas
            else:
                normal = _FACE_NORMAL[ftype](xyz)  # (nf, dim)
                v = jnp.asarray(vector[: normal.shape[1]], self.dtype)
                per_face = (normal @ v) * meas
            nfn = conn.shape[1]
            contrib = jnp.repeat(per_face / nfn, nfn)
            dofs = jnp.asarray(self.dof_ids(conn.reshape(-1), comp))
            rhs = rhs.at[dofs].add(contrib)
        return rhs

    # -- Dirichlet methods ------------------------------------------------------
    def group_dofs(self, group: str, comp: int = 0) -> np.ndarray:
        return self.dof_ids(self.mesh.group_nodes(group), comp)

    def apply_dirichlet(
        self,
        system: LinearSystem,
        dofs: np.ndarray,
        value: float | jnp.ndarray,
        method: str = "Penalty",
        penalty: float = 1.0e30,
    ) -> None:
        """The four enforcement methods of the reference
        (modules/elasticity/FemModule.cc:285-400, FemBoundaryConditions.axl
        enforce-Dirichlet-method): Penalty, WeakPenalty, RowElimination,
        RowColumnElimination.
        """
        dofs = np.asarray(dofs)
        vals = jnp.broadcast_to(jnp.asarray(value, self.dtype), dofs.shape)
        system.add_guess(dofs, vals)
        if method == "Penalty":
            system.set_forced_diag(dofs, jnp.full(dofs.shape, penalty, self.dtype))
            system.set_rhs(dofs, penalty * vals)
        elif method == "WeakPenalty":
            # matrixAddValue(diag, P) instead of set
            flat = system.matrix.flat_values()
            node = dofs // self.ndof
            comp = dofs % self.ndof
            slots = self.topo.diag_slot[node]
            flat = flat.at[jnp.asarray(slots), jnp.asarray(comp), jnp.asarray(comp)].add(penalty)
            system.matrix = system.matrix.with_values(flat)
            system.set_rhs(dofs, penalty * vals)
        elif method == "RowElimination":
            system.eliminate_row(dofs, vals)
        elif method == "RowColumnElimination":
            system.eliminate_row_col(dofs, vals)
        else:
            raise ValueError(f"unknown Dirichlet method '{method}'")

    # -- solution handling -----------------------------------------------------
    def node_values(self, x: jnp.ndarray) -> np.ndarray:
        """Solution as (n_nodes, ndof) host array (the _updateVariables copy)."""
        return np.asarray(x).reshape(self.mesh.n_nodes, self.ndof)
