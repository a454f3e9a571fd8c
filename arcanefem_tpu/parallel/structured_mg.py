"""Sharded geometric multigrid over x-slab decomposition.

Extends the x-slab structured path (structured_sharded.py) from Jacobi-PCG
to multigrid-preconditioned CG — the multi-chip form of the flagship
solve (solver/multigrid.py, the reference's BoomerAMG+PCG role,
femutils/HypreDoFLinearSystem.cc:686-742).

Per level, everything stays slab-local except three plane exchanges:

* SpMV / smoothing / residual: the two `ppermute` halo swaps of
  structured_sharded._halo_spmv;
* restriction: one `ppermute` (the left neighbour's last interior fine
  plane feeds coarse plane 0 of each slab);
* prolongation: one `ppermute` (the right neighbour's plane 0 refreshes
  the shared coarse tail plane).

The hierarchy coarsens all three axes 2x per level while the per-device
plane count stays even, so every level keeps the same disjoint plane
ownership (the shared tail plane belongs to the right neighbour and is
held at zero on non-owners — `ppermute`'s zero fill for unaddressed
receivers doubles as the global-boundary zero pad of the transfer
stencils).  Coarse coordinates/masks are sliced host-side per level;
coarse operators are re-discretisations on the coarsened slabs (same
discipline as solver/multigrid.build_mg).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.structured import StructuredBox
from ..solver.multigrid import _prolong_axis, _restrict_axis
from .structured_sharded import (
    AXIS,
    SlabPlan,
    _halo_spmv,
    _local_assemble,
    plan_slabs,
    slab_coords,
    slab_mask_values,
)


@dataclass
class MGSlabPlan:
    levels: list  # of SlabPlan, fine -> coarse

    @property
    def fine(self) -> SlabPlan:
        return self.levels[0]


def plan_mg_slabs(box: StructuredBox, n_dev: int, min_size: int = 2) -> MGSlabPlan:
    """Coarsen 2x per axis while the grid AND the per-device slab allow it."""
    levels = [plan_slabs(box, n_dev)]
    b = box
    while not (
        b.nx % 2 or b.ny % 2 or b.nz % 2
        or (b.nx // 2) % n_dev
        or min(b.nx, b.ny, b.nz) // 2 < min_size
    ):
        b = StructuredBox(b.nx // 2, b.ny // 2, b.nz // 2, b.lx, b.ly, b.lz)
        levels.append(plan_slabs(b, n_dev))
    return MGSlabPlan(levels=levels)


def mg_slab_coords(plan: MGSlabPlan, coords3d: np.ndarray) -> list:
    """Per-level ghosted coordinate slabs (host-side 2x decimation)."""
    out = []
    c = np.asarray(coords3d)
    for lv in plan.levels:
        out.append(slab_coords(lv, c))
        c = c[::2, ::2, ::2]
    return out


def mg_slab_masks(plan: MGSlabPlan, bc_planes=("xmin", "xmax")) -> list:
    """Per-level Dirichlet mask slabs as float (1.0 on Dirichlet rows)."""
    out = []
    for lv in plan.levels:
        m = lv.box.boundary_mask(bc_planes).astype(np.float64)
        ms, _ = slab_mask_values(lv, m, np.zeros_like(m))
        out.append(ms)
    return out


def _restrict_x_slab(f3: jnp.ndarray, pxc: int, n_dev: int) -> jnp.ndarray:
    """Full-weighting along x on a slab: out[j] = f[2j] + 0.5(f[2j-1]+f[2j+1]).

    f3: (pxf+1, ...) local fine planes.  The left halo plane comes from the
    left neighbour; device 0 receives ppermute's zero fill = the global
    boundary zero pad.  The returned tail plane (j = pxc) is only correct
    on the last device — callers mask it with the ownership/maskmul plane.
    """
    left = jax.lax.ppermute(
        f3[-2], AXIS, [(i, i + 1) for i in range(n_dev - 1)]
    )
    fx = jnp.concatenate([left[None], f3], axis=0)  # fine plane p at fx[p+1]
    hi = jnp.concatenate([fx[2::2], jnp.zeros_like(fx[:1])], axis=0)
    return fx[1::2] + 0.5 * (fx[0::2] + hi)


def _prolong_x_slab(c3: jnp.ndarray, pxc: int, n_dev: int) -> jnp.ndarray:
    """Linear interpolation along x on a slab: (pxc+1, ...) -> (2·pxc+1, ...).

    The shared coarse tail plane is refreshed from its owner (right
    neighbour's plane 0) before interpolating.
    """
    tail_sync = jax.lax.ppermute(
        c3[0], AXIS, [(i, i - 1) for i in range(1, n_dev)]
    )
    is_last = jax.lax.axis_index(AXIS) == n_dev - 1
    tail = jnp.where(is_last, c3[pxc], tail_sync)
    ce = jnp.concatenate([c3[:pxc], tail[None]], axis=0)
    mid = 0.5 * (ce[:-1] + ce[1:])
    body = jnp.stack([ce[:-1], mid], axis=1)
    body = body.reshape((2 * pxc,) + c3.shape[1:])
    return jnp.concatenate([body, ce[-1:]], axis=0)


def make_structured_mg_step(
    plan: MGSlabPlan,
    mesh: jax.sharding.Mesh,
    rtol: float = 1e-8,
    max_iter: int = 500,
    penalty: float = 1e12,
    nu: int = 1,
    omega: float = 0.8,
    coarse_iters: int = 40,
):
    """Jitted sharded MG-PCG step.

    fn(cslabs_per_level, masks_per_level, gvals, f)
      -> (x (D, own_planes*plane), iters, res)

    cslabs_per_level / masks_per_level: tuples from mg_slab_coords /
    mg_slab_masks, device_put with the x-slab sharding; gvals: level-0
    Dirichlet values slab (slab_mask_values).
    """
    levels = plan.levels
    D = levels[0].n_dev
    nlev = len(levels)
    P = jax.sharding.PartitionSpec

    def shard_fn(cslabs, masks, gvals, f):
        cslabs = [c[0] for c in cslabs]
        masks = [m[0] for m in masks]
        gvals = gvals[0]
        dtype = cslabs[0].dtype

        is_last = jax.lax.axis_index(AXIS) == D - 1
        bands_l, inv_l, maskmul_l, shapes_l = [], [], [], []
        rhs0 = None
        for l, lv in enumerate(levels):
            box, px = lv.box, lv.px
            d0 = box.offsets.index(0)
            bands, rhs = _local_assemble(box, px, cslabs[l], f)
            # ownership: the shared tail plane is the right neighbour's
            # plane 0 — zero its rows everywhere but on the last device
            tail = jnp.arange(px + 1) == px
            valid = jnp.where(tail[:, None] & ~is_last, 0.0, 1.0).astype(dtype)
            valid = valid.repeat(lv.plane, 1).reshape(-1)
            bands = bands * valid[None, :]
            mask = masks[l].astype(dtype)
            pen = jnp.asarray(penalty, dtype)
            bands = bands.at[d0].set(
                jnp.where(mask > 0.5, pen, bands[d0])
            )
            diag = bands[d0]
            inv = jnp.where(diag != 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 0.0)
            bands_l.append(bands)
            inv_l.append(inv)
            maskmul_l.append((1.0 - mask) * valid)
            shapes_l.append((px + 1, box.ny + 1, box.nz + 1))
            if l == 0:
                rhs0 = rhs * valid
                mask0 = mask

        def spmv(l, x):
            return _halo_spmv(levels[l].box, levels[l].px, bands_l[l], x, D)

        def smooth0(l, b, sweeps):
            x = omega * inv_l[l] * b
            for _ in range(sweeps - 1):
                x = x + omega * inv_l[l] * (b - spmv(l, x))
            return x

        def restrict(l, r):
            r3 = r.reshape(shapes_l[l])
            r3 = _restrict_axis(_restrict_axis(r3, 1), 2)
            rc = _restrict_x_slab(r3, levels[l + 1].px, D)
            return rc.reshape(-1)

        def prolong(l, xc):
            c3 = xc.reshape(shapes_l[l + 1])
            f3 = _prolong_x_slab(c3, levels[l + 1].px, D)
            f3 = _prolong_axis(_prolong_axis(f3, 1), 2)
            return f3.reshape(-1)

        def vcycle(l, b):
            if l == nlev - 1:
                return smooth0(l, b, coarse_iters)
            x = smooth0(l, b, nu)
            r = (b - spmv(l, x)) * maskmul_l[l]
            rc = restrict(l, r) * maskmul_l[l + 1]
            xc = vcycle(l + 1, rc) * maskmul_l[l + 1]
            x = x + prolong(l, xc)
            for _ in range(nu):
                x = x + omega * inv_l[l] * (b - spmv(l, x))
            return x

        def M_apply(r):
            z = vcycle(0, r * maskmul_l[0])
            return jnp.where(mask0 > 0.5, r * inv_l[0], z)

        # penalty Dirichlet on the fine rhs + warm start
        rhs = jnp.where(mask0 > 0.5, jnp.asarray(penalty, dtype) * gvals, rhs0)
        x0 = jnp.where(mask0 > 0.5, gvals, 0.0).astype(dtype)

        def pdot(a, b):
            return jax.lax.psum(
                jnp.vdot(a, b), AXIS)

        r0 = rhs - spmv(0, x0)
        z0 = M_apply(r0)
        rz0 = pdot(r0, z0)
        tol2 = rtol * rtol * jnp.abs(rz0)

        def cond(st):
            return (jnp.abs(st[4]) > tol2) & (st[5] < max_iter)

        def body(st):
            x, r, z, p, rz, k = st
            Ap = spmv(0, p)
            alpha = rz / pdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M_apply(r)
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
        in_specs=(
            tuple(pspec for _ in levels),
            tuple(pspec for _ in levels),
            pspec, P(),
        ),
        out_specs=(pspec, P(), P()),
        check_vma=False,
    )
    return jax.jit(smapped)
