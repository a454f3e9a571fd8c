"""Lane-major tetra assembly — P1 stiffness at benchmark scale.

The element-centric layouts of ops/elements.py ((nc, npc, dim) tensors)
suit case-study sizes; at benchmark scale every intermediate here is a
(k, nc) stack of contiguous per-cell vectors instead (the CELL axis is
last), so the element computation is one fused elementwise pass and every
read and write is coalesced.

The reduction into BELL slots is a scatter-add per (i, j) entry of the
element matrix: ``segment_sum`` semantics, which the GPU executes with
native atomics — the reference's own cell-parallel atomic assembly
(BSRFormat.h:842-932).  Atomics sum in a run-dependent order, so values
agree with a sequential sum to rounding, not bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.topology import Topology


class TetraLaneAssembler:
    """Assemble the P1 tetra stiffness into BELL (n, W) values.

    asm = TetraLaneAssembler(topo, conn); vals = asm(coords)  # (n, W)

    coords: (n, 3) f32 device array.  The transposed connectivity and slot
    map are built once on the host and passed to the jitted kernel as
    arguments (never embedded as constants).
    """

    def __init__(self, topo: Topology, conn: np.ndarray):
        self.topo = topo
        self.n_cells = conn.shape[0]
        sm = np.asarray(topo.slot_maps["tetra4"])  # (nc, 16), cell-major
        # lane-major entry order e = (i*4+j)*nc + c; i32 halves the map and
        # n_slots = N·W < 2^31 for every mesh a single device can hold
        smdt = np.int32 if topo.n_slots < 2**31 else np.int64
        self.slot_map_t = jnp.asarray(
            np.ascontiguousarray(sm.T.astype(smdt)).reshape(-1)
        )
        self.conn_dev = jnp.asarray(np.asarray(conn, np.int32).T)  # (4, nc)

    def __call__(self, coords: jnp.ndarray) -> jnp.ndarray:
        t = self.topo
        return _assemble(
            coords.astype(jnp.float32), self.conn_dev, self.slot_map_t,
            nc=self.n_cells, n=t.n_nodes, W=t.width, n_slots=t.n_slots,
        )


def tetra_cofactors(x, y, z):
    """Per-cell P1 gradients scaled by |6V|, and 1/|6V|.

    x, y, z: lists of the 4 corner coordinate vectors, each (nc,).
    Returns (dx, dy, dz, inv) with dx[i] = |6V|·∂N_i/∂x up to sign
    (ArcaneFemFunctions.h:690-816 pattern) and inv = 1/|6V|.
    """
    ax, ay, az = x[1] - x[0], y[1] - y[0], z[1] - z[0]
    bx, by, bz = x[2] - x[0], y[2] - y[0], z[2] - z[0]
    cx, cy, cz = x[3] - x[0], y[3] - y[0], z[3] - z[0]
    v6 = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz) + az * (
        bx * cy - by * cx
    )
    inv = 1.0 / jnp.abs(v6)

    def comp(u, w):
        return [
            u[1] * (w[3] - w[2]) + u[2] * (w[1] - w[3]) + u[3] * (w[2] - w[1]),
            u[0] * (w[2] - w[3]) + u[2] * (w[3] - w[0]) + u[3] * (w[0] - w[2]),
            u[0] * (w[3] - w[1]) + u[1] * (w[0] - w[3]) + u[3] * (w[1] - w[0]),
            u[0] * (w[1] - w[2]) + u[1] * (w[2] - w[0]) + u[2] * (w[0] - w[1]),
        ]

    return comp(y, z), comp(z, x), comp(x, y), inv


def _assemble_impl(coords, conn_dev, slot_map_t, nc, n, W, n_slots):
    xg = coords[:, 0][conn_dev]
    yg = coords[:, 1][conn_dev]
    zg = coords[:, 2][conn_dev]
    # corners relative to corner 0: the cofactors are translation-
    # invariant, and products of absolute coordinates would cancel to
    # ~h² from terms ~|x|·h, losing log2(|x|/h) bits in f32
    dx, dy, dz, inv = tetra_cofactors(
        *[[g[i] - g[0] for i in range(4)] for g in (xg, yg, zg)])
    # ke_ij = V * (dx_i dx_j + dy_i dy_j + dz_i dz_j) / (6V)^2; V = |6V|/6
    scale = inv / 6.0
    # one scatter-add per (i, j) entry instead of a stacked (16, nc) ke:
    # the same scattered elements without a 16·nc intermediate
    vals = jnp.zeros(n_slots, jnp.float32)
    for q, (i, j) in enumerate(
        [(i, j) for i in range(4) for j in range(4)]
    ):
        keq = (dx[i] * dx[j] + dy[i] * dy[j] + dz[i] * dz[j]) * scale
        vals = vals.at[
            jax.lax.slice_in_dim(slot_map_t, q * nc, (q + 1) * nc)
        ].add(keq)
    return vals.reshape(n, W)


_assemble = jax.jit(_assemble_impl,
                    static_argnames=("nc", "n", "W", "n_slots"))
