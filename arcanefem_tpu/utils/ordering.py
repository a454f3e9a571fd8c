"""Bandwidth-reducing node orderings (host, once per mesh).

Reverse Cuthill-McKee over the node graph.  The reference leaves DoF order
to Arcane's mesh numbering; here a small bandwidth keeps the SpMV's
gather of x local (cache reuse), and renumber_mesh also sorts cells by
minimum node so the assembly's reads stay local too.
"""

from __future__ import annotations

import numpy as np

from ..mesh.core import Mesh


def rcm_order(n_nodes: int, row_ptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: perm[new] = old."""
    deg = np.diff(row_ptr)
    visited = np.zeros(n_nodes, bool)
    order = np.empty(n_nodes, np.int64)
    pos = 0
    nodes_by_deg = np.argsort(deg, kind="stable")
    for seed in nodes_by_deg:
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            nb = cols[row_ptr[u] : row_ptr[u + 1]]
            nb = nb[~visited[nb]]
            if len(nb):
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                order[pos : pos + len(nb)] = nb
                pos += len(nb)
    return order[::-1].copy()


def renumber_mesh(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """Return a mesh with nodes re-ordered by perm (perm[new] = old)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    def renum_sort(c):
        c2 = inv[c].astype(np.int32)
        # sort cells by min node so the cell-major entry array is also
        # bandwidth-local (the assembly reads stay local)
        return c2[np.argsort(c2.min(axis=1), kind="stable")]

    return Mesh(
        coords=mesh.coords[perm],
        node_uids=mesh.node_uids[perm],
        cells={t: renum_sort(c) for t, c in mesh.cells.items()},
        dim=mesh.dim,
        face_groups={
            g: {t: inv[c].astype(np.int32) for t, c in fg.items()}
            for g, fg in mesh.face_groups.items()
        },
        node_groups={
            g: inv[v].astype(np.int32) for g, v in mesh.node_groups.items()
        },
        cell_groups={
            g: {t: inv[c].astype(np.int32) for t, c in cg.items()}
            for g, cg in mesh.cell_groups.items()
        },
    )
