"""BELL (blocked-ELLPACK) sparse matrix — the device BSR.

Role of the reference's ``BSRMatrix<BLOCK_SIZE>`` (femutils/BSRFormat.h:104-336)
with rows padded to a fixed width ``W`` so that SpMV is a fully regular

    gather x[cols] -> (N, W, b) ; einsum blocks -> (N, W, b) ; sum over W

with no scatters, no atomics, no per-row loops — bandwidth-bound and
XLA-fusable.  The einsum runs at the process-wide matmul precision that
``utils/device.setup`` pins to HIGHEST, so an f32 SpMV never drops to
TF32.  Padding entries point at their own row with zero value, so
they contribute nothing and every gather is in-bounds.

The object is a JAX pytree: `values` is traced, everything static lives in
the Topology (host).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .topology import Topology


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["values", "cols"],
    meta_fields=["topo", "block"],
)
@dataclass
class BellMatrix:
    """values: (N, W, b, b) block coefficients; topo/block are static."""

    values: jnp.ndarray
    topo: Topology
    block: int
    # ELL columns as a DEVICE buffer (optional).  Without it, spmv wraps
    # topo.ell_cols, which jit embeds as an HLO literal — fine for small
    # meshes but it bloats compiles at ~1M+ nodes.  assemble_bell sets it.
    cols: jnp.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return self.topo.n_nodes

    @property
    def n_dofs(self) -> int:
        return self.topo.n_nodes * self.block

    def flat_values(self) -> jnp.ndarray:
        """(N*W, b, b) view used by slot-indexed updates."""
        N, W, b, _ = self.values.shape
        return self.values.reshape(N * W, b, b)

    def with_values(self, values: jnp.ndarray) -> "BellMatrix":
        return BellMatrix(values=values.reshape(self.values.shape),
                          topo=self.topo, block=self.block, cols=self.cols)

    # -- linear algebra ----------------------------------------------------

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x with x of shape (n_dofs,)."""
        b = self.block
        xn = x.reshape(self.n_nodes, b)
        cols = self.cols if self.cols is not None else jnp.asarray(self.topo.ell_cols)
        gathered = xn[cols]  # (N, W, b)
        y = jnp.einsum(
            "nwab,nwb->na", self.values, gathered,
            preferred_element_type=self.values.dtype,
        )
        return y.reshape(-1)

    def diagonal(self) -> jnp.ndarray:
        """(n_dofs,) scalar diagonal of the matrix."""
        dblocks = self.flat_values()[jnp.asarray(self.topo.diag_slot)]  # (N,b,b)
        return jnp.diagonal(dblocks, axis1=1, axis2=2).reshape(-1)

    def diag_blocks(self) -> jnp.ndarray:
        """(N, b, b) diagonal blocks (for block-Jacobi)."""
        return self.flat_values()[jnp.asarray(self.topo.diag_slot)]

    # -- interop -----------------------------------------------------------

    def todense(self) -> jnp.ndarray:
        """Dense (n_dofs, n_dofs) matrix — tests/small systems only.

        The role of BSRMatrix::toCsr expansion (BSRFormat.h:194-256) for the
        dense sequential backend (DoFLinearSystem.cc:56-252).
        """
        t = self.topo
        b = self.block
        n = t.n_nodes
        rows = np.repeat(np.arange(n, dtype=np.int64), t.width)
        cols = t.ell_cols.astype(np.int64).reshape(-1)
        comp = np.arange(b, dtype=np.int64)
        shape = (len(rows), b, b)
        row_dof = np.broadcast_to(rows[:, None, None] * b + comp[None, :, None], shape)
        col_dof = np.broadcast_to(cols[:, None, None] * b + comp[None, None, :], shape)
        dense = jnp.zeros((n * b, n * b), self.values.dtype)
        return dense.at[
            jnp.asarray(row_dof.reshape(-1)), jnp.asarray(col_dof.reshape(-1))
        ].add(self.flat_values().reshape(-1))


def assemble_bell(
    topo: Topology,
    element_matrices: dict[str, jnp.ndarray],
    block: int,
    dtype=None,
) -> BellMatrix:
    """Sum per-cell element matrices into the global BELL matrix.

    element_matrices[bucket]: (nc, npc, npc) for block==1 or
    (nc, npc, npc, b, b) for block>1 — the batched output of an element
    kernel.  The scatter of the reference's assembleBilinearAtomic
    (BSRFormat.h:786-932) becomes a single deterministic segment-sum into
    the flat (N*W) block-slot space.
    """
    n_slots = topo.n_slots
    acc = None
    for name, ke in element_matrices.items():
        slots = jnp.asarray(topo.slot_maps[name].reshape(-1))
        if block == 1:
            flat = ke.reshape(-1, 1, 1)
        else:
            flat = ke.reshape(-1, block, block)
        part = jax.ops.segment_sum(flat, slots, num_segments=n_slots)
        acc = part if acc is None else acc + part
    if dtype is not None:
        acc = acc.astype(dtype)
    values = acc.reshape(topo.n_nodes, topo.width, block, block)
    return BellMatrix(values=values, topo=topo, block=block,
                      cols=jnp.asarray(topo.ell_cols))
