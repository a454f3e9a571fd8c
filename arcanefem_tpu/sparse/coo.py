"""Standalone COO sparse matrix — the CooFormatMatrix role
(reference femutils/CooFormatMatrix.h:37-355).

Unlike BELL/CSR (sparse/topology.py), COO needs NO precomputed sparsity:
rows/cols/vals are emitted straight from cell connectivity with duplicates
kept, exactly like the reference's `matrixAddValue` accumulation.  The
device operations on it:

* ``spmv`` — duplicates are summed on the fly by a segment-sum over rows
  (deterministic; the role of the reference's atomicAdd translate loop).
* ``sorted()`` — entries sorted by (row, col) packed key and merged, the
  S-COO variant (testlab CooSortBiliAssembly).
* ``to_bell(topo)`` — translate into the BELL linear-system layout via a
  binary search into the topology's CSR columns
  (CooFormatMatrix::translateToLinearSystem, h:88-95).

The search/sort happen ONCE per mesh on the host; the value path (device)
is a pure gather + segment-sum, so repeated assemblies jit-cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bell import BellMatrix
from .topology import Topology


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows", "cols", "vals"],
    meta_fields=["n"],
)
@dataclass
class CooMatrix:
    """(nnz,) triplets; duplicates allowed (accumulating semantics).

    rows/cols are HOST (NumPy) index arrays — static per mesh, usable
    for host-side sort/search even when the value path is being traced
    (vals may be a jit tracer)."""

    rows: np.ndarray  # int32, host
    cols: np.ndarray  # int32, host
    vals: jnp.ndarray
    n: int

    @property
    def nnz_stored(self) -> int:
        return int(self.rows.shape[0])

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        return jax.ops.segment_sum(
            self.vals * x[self.cols], self.rows, num_segments=self.n
        )

    def sorted(self) -> "CooMatrix":
        """S-COO: sort by packed (row, col) key and merge duplicates."""
        key = np.asarray(self.rows, np.int64) * self.n + np.asarray(
            self.cols, np.int64
        )
        order = np.argsort(key, kind="stable")
        skey = key[order]
        uniq, inv = np.unique(skey, return_inverse=True)
        vals = jax.ops.segment_sum(
            self.vals[jnp.asarray(order)],
            jnp.asarray(inv),
            num_segments=len(uniq),
            indices_are_sorted=True,
        )
        return CooMatrix(
            rows=(uniq // self.n).astype(np.int32),
            cols=(uniq % self.n).astype(np.int32),
            vals=vals,
            n=self.n,
        )

    def to_bell(self, topo: Topology) -> BellMatrix:
        """Translate into the BELL system layout (translateToLinearSystem).

        The (row, col) -> value-slot lookup is a host-side binary search
        into the topology's CSR columns — the reference does the same
        per-entry `indexValue` scan (CooFormatMatrix.h:69-87), we batch it.
        """
        r = np.asarray(self.rows, np.int64)
        c = np.asarray(self.cols, np.int64)
        rp = np.asarray(topo.row_ptr, np.int64)
        cc = np.asarray(topo.csr_cols, np.int64)
        # one batched binary search over the packed (row, col) keys —
        # columns are sorted within each CSR row, so the packed key array
        # is globally sorted
        key_all = np.repeat(
            np.arange(topo.n_nodes, dtype=np.int64), np.diff(rp)
        ) * self.n + cc
        pos = np.searchsorted(key_all, r * self.n + c)
        # clip before indexing so an out-of-range key hits the diagnostic
        # assert below instead of an opaque IndexError
        pos = np.minimum(pos, len(key_all) - 1)
        assert np.all(key_all[pos] == r * self.n + c), (
            "COO entry outside the topology sparsity"
        )
        ell_slot = np.asarray(topo.csr_to_ell, np.int64)[pos]
        vals = jax.ops.segment_sum(
            self.vals, jnp.asarray(ell_slot), num_segments=topo.n_slots
        )
        return BellMatrix(
            values=vals.reshape(topo.n_nodes, topo.width, 1, 1),
            topo=topo,
            block=1,
            cols=jnp.asarray(topo.ell_cols),
        )

    def todense(self) -> np.ndarray:
        d = np.zeros((self.n, self.n))
        np.add.at(
            d, (np.asarray(self.rows), np.asarray(self.cols)),
            np.asarray(self.vals),
        )
        return d


def coo_from_elements(
    n_nodes: int, conns: dict[str, np.ndarray], mats: dict[str, jnp.ndarray]
) -> CooMatrix:
    """Emit COO triplets from element matrices — no sparsity build.

    conns[bucket]: (nc, npc) node ids; mats[bucket]: (nc, npc, npc).
    """
    rows, cols, vals = [], [], []
    for name, conn in conns.items():
        conn = np.asarray(conn, np.int32)
        nc, npc = conn.shape
        rows.append(np.repeat(conn, npc, axis=1).reshape(-1))
        cols.append(np.tile(conn, (1, npc)).reshape(-1))
        vals.append(mats[name].reshape(-1))
    return CooMatrix(
        rows=np.concatenate(rows),
        cols=np.concatenate(cols),
        vals=jnp.concatenate(vals),
        n=n_nodes,
    )
