"""Supernode node ordering: spatial bricks renumbered in brick-graph RCM.

Nodes are grouped into spatial bricks of ~8, the brick quotient graph is
RCM-ordered, and nodes are renumbered by (brick rank, member).  Each
brick's nodes are then consecutive and neighbouring bricks are close in
the order, so the SpMV's gather of x stays local.  This is the default
node order of the unstructured benchmark; whether it beats plain RCM on
the GPU (through L2 locality of x) is an open measurement.
"""

from __future__ import annotations

import numpy as np

BS = 8  # nodes per spatial brick


def supernode_order(topo, coords: np.ndarray, bs: int = BS) -> np.ndarray:
    """Node permutation for supernode blocking: spatial bricks of ~bs
    nodes, brick quotient graph RCM, nodes ordered by (brick rank,
    member).  Returns perm with perm[new_id] = old_id (the convention of
    utils.ordering.rcm_order / renumber_mesh)."""
    from ..utils.ordering import rcm_order

    n, dim = coords.shape
    lo, hi = coords.min(0), coords.max(0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-30)))
    edge = (bs * vol / max(n, 1)) ** (1.0 / dim)
    cell = np.floor((coords - lo) / max(edge, 1e-30)).astype(np.int64)
    dims = cell.max(0) + 1
    key = cell[:, 0]
    for d in range(1, dim):
        key = key * dims[d] + cell[:, d]
    _, brick = np.unique(key, return_inverse=True)
    nb = int(brick.max()) + 1

    # brick quotient graph (CSR) from the node adjacency
    rp, cc = topo.row_ptr.astype(np.int64), topo.csr_cols.astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(rp))
    bk = np.unique(brick[rows] * np.int64(nb) + brick[cc])
    br, bc = (bk // nb).astype(np.int64), (bk % nb).astype(np.int64)
    bptr = np.zeros(nb + 1, np.int64)
    np.add.at(bptr, br + 1, 1)
    np.cumsum(bptr, out=bptr)
    bperm = rcm_order(nb, bptr, bc)  # bperm[new_brick] = old_brick
    rank = np.empty(nb, np.int64)
    rank[bperm] = np.arange(nb)
    return np.lexsort((np.arange(n), rank[brick])).astype(np.int64)
