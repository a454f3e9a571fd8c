"""Sharded structured-box solver: x-slab domain decomposition.

The multi-chip form of the flagship structured path (mesh/structured.py):
node planes are split into contiguous x-slabs over the device mesh.  All
15 stencil offsets reach at most one x-plane, so

* assembly is fully local — each device holds its coordinate slab plus one
  ghost hex plane per side (the recompute-overlap discipline, zero
  communication);
* SpMV halo exchange is two `jax.lax.ppermute` plane swaps per iteration
  (the `synchronize()` role over ICI);
* CG dot products are `psum`s.

Plane ownership is disjoint (device d owns node planes [d·px, (d+1)·px),
the last device also owns the final plane), so reductions need no masking
beyond the padded tail plane whose rows are all-zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.structured import StructuredBox, _HEX_CORNERS, _TETS
from ..ops.geometry import tetra4_gradients

AXIS = "xslabs"


@dataclass
class SlabPlan:
    box: StructuredBox
    n_dev: int
    px: int  # hex planes per device (nx/D)
    own_planes: int  # px + 1 (last plane valid only on the last device)

    @property
    def plane(self) -> int:  # nodes per plane
        return (self.box.ny + 1) * (self.box.nz + 1)


def plan_slabs(box: StructuredBox, n_dev: int) -> SlabPlan:
    if box.nx % n_dev:
        raise ValueError(f"nx={box.nx} must divide by {n_dev} devices")
    return SlabPlan(box=box, n_dev=n_dev, px=box.nx // n_dev,
                    own_planes=box.nx // n_dev + 1)


def slab_coords(plan: SlabPlan, coords3d: np.ndarray) -> np.ndarray:
    """(D, px+3, ny+1, nz+1, 3) coordinate slabs with one ghost plane per
    side (edge-duplicated at the domain boundary -> degenerate ghost hexes)."""
    box, D, px = plan.box, plan.n_dev, plan.px
    cp = np.pad(np.asarray(coords3d), ((1, 1), (0, 0), (0, 0), (0, 0)),
                mode="edge")
    slabs = np.stack([cp[d * px : d * px + px + 3] for d in range(D)])
    return slabs


def slab_mask_values(plan: SlabPlan, mask: np.ndarray, values: np.ndarray):
    """Split global (n_nodes,) arrays into (D, own_planes*plane) slabs.

    The shared tail plane belongs to the NEXT device; on devices other than
    the last it is a pad plane (mask False, value 0, matrix rows zero)."""
    box, D, px = plan.box, plan.n_dev, plan.px
    pl = plan.plane
    m3 = np.asarray(mask).reshape(box.nx + 1, pl)
    v3 = np.asarray(values).reshape(box.nx + 1, pl)
    ms, vs = [], []
    for d in range(D):
        lo = d * px
        m = np.zeros((px + 1, pl), m3.dtype)
        v = np.zeros((px + 1, pl), v3.dtype)
        n_own = px + 1 if d == D - 1 else px
        m[:n_own] = m3[lo : lo + n_own]
        v[:n_own] = v3[lo : lo + n_own]
        ms.append(m.reshape(-1))
        vs.append(v.reshape(-1))
    return np.stack(ms), np.stack(vs)


def gather_global(plan: SlabPlan, x_shards: np.ndarray) -> np.ndarray:
    """(D, own_planes*plane) -> (n_nodes,)."""
    box, D, px = plan.box, plan.n_dev, plan.px
    pl = plan.plane
    out = np.zeros((box.nx + 1) * pl, x_shards.dtype)
    x3 = np.asarray(x_shards).reshape(D, px + 1, pl)
    for d in range(D):
        n_own = px + 1 if d == D - 1 else px
        out[d * px * pl : (d * px + n_own) * pl] = x3[d, :n_own].reshape(-1)
    return out


def _local_assemble(box: StructuredBox, px: int, cslab, f):
    """Bands + source rhs for the device's px+1 node planes from its
    (px+3, ny+1, nz+1, 3) ghosted coordinate slab.  Ghost hexes at the
    domain edges are degenerate (zero volume) and contribute zero."""
    ny, nz = box.ny, box.nz
    nhx = px + 2  # hex planes covered by the slab (incl. ghosts)
    dtype = cslab.dtype
    bands = {d: jnp.zeros((px + 1, ny + 1, nz + 1), dtype) for d in box.offsets}
    rhs = jnp.zeros((px + 1, ny + 1, nz + 1), dtype)

    def corner(c):
        di, dj, dk = _HEX_CORNERS[c]
        return cslab[di : di + nhx, dj : dj + ny, dk : dk + nz].reshape(-1, 3)

    for tet in _TETS:
        xyz = jnp.stack([corner(c) for c in tet], axis=1)
        v6 = jnp.abs(
            jnp.einsum(
                "ni,ni->n",
                xyz[:, 1] - xyz[:, 0],
                jnp.cross(xyz[:, 2] - xyz[:, 0], xyz[:, 3] - xyz[:, 0]),
            )
        )
        inv = jnp.where(v6 > 1e-30, 1.0 / jnp.where(v6 > 1e-30, v6, 1.0), 0.0)
        vol = v6 / 6.0
        gx, gy, gz = tetra4_gradients(
            jnp.where(v6[:, None, None] > 1e-30, xyz, xyz.at[:, 1:].set(xyz[:, :1] + jnp.eye(3)[None]))
        )
        # guarded gradients: degenerate ghost hexes get a unit tet whose
        # contribution is zeroed below via vol==0
        for a, ca in enumerate(tet):
            dia, dja, dka = _HEX_CORNERS[ca]
            la = box._lin(_HEX_CORNERS[ca])
            for b, cb in enumerate(tet):
                d = box._lin(_HEX_CORNERS[cb]) - la
                contrib = (
                    vol * (gx[:, a] * gx[:, b] + gy[:, a] * gy[:, b] + gz[:, a] * gz[:, b])
                ).reshape(nhx, ny, nz)
                # hex plane h contributes to node plane h-1+dia of the slab
                # (hex plane 0 is the left ghost); keep planes [0, px+1)
                lo_hex = 1 - dia  # hex plane writing node plane 0
                bands[d] = bands[d].at[:, dja : dja + ny, dka : dka + nz].add(
                    contrib[lo_hex : lo_hex + px + 1]
                )
            contrib_r = (f * vol / 4.0).reshape(nhx, ny, nz)
            lo_hex = 1 - dia
            rhs = rhs.at[:, dja : dja + ny, dka : dka + nz].add(
                contrib_r[lo_hex : lo_hex + px + 1]
            )
    stacked = jnp.stack([bands[d].reshape(-1) for d in box.offsets])
    return stacked, rhs.reshape(-1)


def _halo_spmv(box: StructuredBox, px: int, bands, x, n_dev: int):
    """y = A x with ppermute halo exchange.

    Each shard's local vector covers node planes [d·px, d·px+px]; the tail
    plane is owned by the right neighbor (its plane 0), so it is refreshed
    from there each SpMV, and one extra left-halo plane (the left
    neighbor's plane px−1) prepends the window.  Offsets that reach past
    the window wrap via roll — they always hit zero band values (they
    correspond to neighbors outside the y/z domain or beyond the box).
    """
    pl = (box.ny + 1) * (box.nz + 1)
    x2 = x.reshape(px + 1, pl)
    # refresh the shared tail plane from its owner (right neighbor plane 0)
    tail_sync = jax.lax.ppermute(
        x2[0], AXIS, [(i, i - 1) for i in range(1, n_dev)]
    )
    is_last = jax.lax.axis_index(AXIS) == n_dev - 1
    tail = jnp.where(is_last, x2[px], tail_sync)
    left_halo = jax.lax.ppermute(
        x2[px - 1], AXIS, [(i, i + 1) for i in range(n_dev - 1)]
    )
    x_ext = jnp.concatenate(
        [left_halo[None], x2[:px], tail[None]], axis=0
    ).reshape(-1)  # (px+2) planes; local plane p sits at ext plane p+1
    y = None
    for k, off in enumerate(box.offsets):
        t = bands[k] * jax.lax.dynamic_slice(
            jnp.roll(x_ext, -off), (pl,), ((px + 1) * pl,)
        )
        y = t if y is None else y + t
    return y


def make_structured_step(plan: SlabPlan, mesh: jax.sharding.Mesh,
                         rtol=1e-7, max_iter=500, penalty=1e12):
    """Jitted sharded step: local assembly + penalty BC + halo-CG.

    fn(cslabs, mask, gvals, f) -> (x (D, own_planes*plane), iters, res)
    """
    box, D, px = plan.box, plan.n_dev, plan.px
    pl_sz = plan.plane
    d0 = box.offsets.index(0)
    P = jax.sharding.PartitionSpec

    def shard_fn(cslab, mask, gvals, f):
        cslab, mask, gvals = cslab[0], mask[0], gvals[0]
        bands, rhs = _local_assemble(box, px, cslab, f)
        # the shared plane is owned by the right neighbor: zero its rows on
        # all but the last device so dot products stay unduplicated
        is_last = jax.lax.axis_index(AXIS) == D - 1
        tail = jnp.arange(px + 1) == px
        valid = jnp.where(
            tail[:, None] & ~is_last, 0.0, 1.0
        ).reshape(-1, 1).repeat(pl_sz, 1).reshape(-1)
        # zero-out non-owned tail plane rows and rhs
        bands = bands * valid[None, :]
        rhs = rhs * valid

        pen = jnp.asarray(penalty, rhs.dtype)
        bands = bands.at[d0].set(jnp.where(mask, pen, bands[d0]))
        rhs = jnp.where(mask, pen * gvals, rhs)

        diag = bands[d0]
        inv = jnp.where(diag != 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 0.0)
        x0 = jnp.where(mask, gvals, 0.0).astype(rhs.dtype)

        def spmv(x):
            return _halo_spmv(box, px, bands, x, D)

        def pdot(a, b):
            return jax.lax.psum(
                jnp.vdot(a, b), AXIS)

        r0 = rhs - spmv(x0)
        z0 = inv * r0
        rz0 = pdot(r0, z0)
        tol2 = rtol * rtol * jnp.abs(rz0)

        def cond(st):
            return (jnp.abs(st[4]) > tol2) & (st[5] < max_iter)

        def body(st):
            x, r, z, p, rz, k = st
            Ap = spmv(p)
            alpha = rz / pdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv * r
            rz_new = pdot(r, z)
            p = z + (rz_new / rz) * p
            return (x, r, z, p, rz_new, k + 1)

        x, _r, _z, _p, rz, k = jax.lax.while_loop(
            cond, body, (x0, r0, z0, z0, rz0, jnp.int32(0))
        )
        rel = jnp.sqrt(jnp.abs(rz) / jnp.maximum(jnp.abs(rz0), 1e-300))
        return x[None], k, rel

    pspec = P(AXIS)
    smapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(pspec, pspec, pspec, P()),
        out_specs=(pspec, P(), P()),
        check_vma=False,
    )
    return jax.jit(smapped)
