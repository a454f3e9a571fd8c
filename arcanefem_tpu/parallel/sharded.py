"""shard_map FEM execution: assembly, halo-exchange SpMV, distributed PCG.

The JAX counterpart of the reference's MPI execution model (SURVEY.md §2.3):

* assembly needs **no communication** — each shard recomputes the element
  matrices of its boundary cells (partition.py builds the overlap), exactly
  the reference's atomic-free recompute discipline;
* SpMV halo exchange = publish-owned + `all_gather` over the device axis +
  gather (the `synchronize()` halo exchange, poisson FemModule.cc:369);
* CG dot products are `psum`s (the reference's `IParallelMng::reduce`,
  testlab FemModule.cc:22-28).

Everything is one jitted function per (mesh, device-count) pair; repeated
solves hit the jit cache.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import elements
from .partition import ShardedProblem

AXIS = "shards"


def device_mesh(n: int) -> jax.sharding.Mesh:
    devs = jax.devices()[:n]
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(jax.devices())}")
    return jax.sharding.Mesh(np.array(devs), (AXIS,))


def put_sharded(sp: ShardedProblem, mesh: jax.sharding.Mesh, dtype=jnp.float32):
    """Move the stacked topology to devices, leading axis sharded."""
    P = jax.sharding.PartitionSpec
    shard = jax.sharding.NamedSharding(mesh, P(AXIS))

    def put(a, dt=None):
        a = np.asarray(a)
        if dt is not None:
            a = a.astype(dt)
        return jax.device_put(a, shard)

    return {
        "ell_cols": put(sp.ell_cols),
        "diag_slot": put(sp.diag_slot),
        "row_valid": put(sp.row_valid),
        "send_idx": put(sp.send_idx),
        "halo_src": put(sp.halo_src),
        "cells_xyz": {k: put(v, dtype) for k, v in sp.cells_xyz.items()},
        "slot_map": {k: put(v) for k, v in sp.slot_map.items()},
        "rhs_map": {k: put(v) for k, v in sp.rhs_map.items()},
    }


# --- per-shard kernels (called inside shard_map; no leading device axis) ---


def shard_assemble(cells_xyz, slot_map, n_own_max, width, coef=1.0):
    """Element kernels + segment-sum into the local flat slot space."""
    n_slots = n_own_max * width + 1  # +1 dump slot
    acc = None
    for name in cells_xyz:
        ke = coef * elements.stiffness(name, cells_xyz[name])
        part = jax.ops.segment_sum(
            ke.reshape(-1),
            slot_map[name].reshape(-1),
            num_segments=n_slots,
        )
        acc = part if acc is None else acc + part
    return acc[:-1].reshape(n_own_max, width)


def shard_source_rhs(cells_xyz, rhs_map, n_own_max, f):
    """rhs[node] += f * measure / npc (constant volume source)."""
    acc = jnp.zeros(n_own_max + 1, list(cells_xyz.values())[0].dtype)
    for name in cells_xyz:
        meas = elements.measure(name, cells_xyz[name])
        npc = rhs_map[name].shape[-1]
        contrib = jnp.repeat(f * meas / npc, npc)
        acc = acc + jax.ops.segment_sum(
            contrib, rhs_map[name].reshape(-1), num_segments=n_own_max + 1
        )
    return acc[:-1]


def shard_halo_x(x_own, send_idx, halo_src):
    """Publish owned values, all_gather the pool, gather halo values."""
    pool = jax.lax.all_gather(x_own[send_idx], AXIS)  # (P, S_max)
    return jnp.concatenate([x_own, pool.reshape(-1)[halo_src]])


def shard_spmv(values, ell_cols, x_own, send_idx, halo_src):
    x_loc = shard_halo_x(x_own, send_idx, halo_src)
    return jnp.sum(values * x_loc[ell_cols], axis=1)


def pdot(a, b):
    return jax.lax.psum(jnp.vdot(a, b), AXIS)


def shard_pcg(spmv, precond, b, x0, rtol, atol, max_iter):
    """Distributed PCG; same convergence criterion as solver.iterative
    (preconditioned-norm, relative to the warm-started initial residual).

    ``precond`` is either an inverse-diagonal array (elementwise Jacobi) or
    a callable r -> M r (e.g. block-Jacobi or a sharded AMG V-cycle)."""
    apply_M = precond if callable(precond) else (lambda r: precond * r)
    r0 = b - spmv(x0)
    z0 = apply_M(r0)
    rz0 = pdot(r0, z0)
    tol2 = jnp.maximum(rtol * rtol * jnp.abs(rz0), atol * atol)

    def cond(st):
        _x, _r, _z, _p, rz, k = st
        return (jnp.abs(rz) > tol2) & (k < max_iter)

    def body(st):
        x, r, z, p, rz, k = st
        Ap = spmv(p)
        alpha = rz / pdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = pdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, k + 1)

    x, _r, _z, _p, rz, k = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, jnp.int32(0))
    )
    rel = jnp.sqrt(jnp.abs(rz) / jnp.maximum(jnp.abs(rz0), 1e-300))
    return x, k, rel


def make_poisson_step(
    sp: ShardedProblem,
    mesh: jax.sharding.Mesh,
    rtol: float = 1.0e-7,
    atol: float = 0.0,
    max_iter: int = 1000,
):
    """Jitted sharded Poisson step: assemble + penalty BC + PCG.

    Returns fn(arrs, f, forced_mask, forced_val, penalty) -> (x, iters, res)
    with x of shape (P, N_own_max) sharded over the device axis.
    `forced_mask`/`forced_val` are (P, N_own_max) stacked penalty-Dirichlet
    masks (host-built from sp.owned_global and the BC node groups).
    """
    n_own_max, width = sp.n_own_max, sp.width
    pspec = jax.sharding.PartitionSpec(AXIS)

    def shard_fn(
        cells_xyz, slot_map, rhs_map, ell_cols, diag_slot,
        send_idx, halo_src, f, forced_mask, forced_val, penalty,
    ):
        # shard_map slices the device axis to length 1; drop it locally
        (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
         halo_src, forced_mask, forced_val) = jax.tree.map(
            lambda a: a[0],
            (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
             halo_src, forced_mask, forced_val),
        )
        values = shard_assemble(cells_xyz, slot_map, n_own_max, width)
        rhs = shard_source_rhs(cells_xyz, rhs_map, n_own_max, f)

        # penalty Dirichlet (HypreDoFLinearSystem.cc:356-382 role)
        flat = values.reshape(-1)
        dvals = jnp.where(forced_mask, penalty, flat[diag_slot])
        values = flat.at[diag_slot].set(dvals).reshape(n_own_max, width)
        rhs = jnp.where(forced_mask, penalty * forced_val, rhs)

        inv_diag_raw = values.reshape(-1)[diag_slot]
        inv_diag = jnp.where(
            inv_diag_raw != 0, 1.0 / jnp.where(inv_diag_raw == 0, 1.0, inv_diag_raw), 0.0
        )
        x0 = jnp.where(forced_mask, forced_val, 0.0).astype(rhs.dtype)

        def spmv(x):
            return shard_spmv(values, ell_cols, x, send_idx, halo_src)

        x, iters, res = shard_pcg(spmv, inv_diag, rhs, x0, rtol, atol, max_iter)
        return x[None], iters, res

    repl = jax.sharding.PartitionSpec()
    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            {k: pspec for k in sp.cells_xyz},
            {k: pspec for k in sp.slot_map},
            {k: pspec for k in sp.rhs_map},
            pspec, pspec, pspec, pspec,
            repl, pspec, pspec, repl,
        ),
        out_specs=(pspec, repl, repl),
        check_vma=False,
    )

    @jax.jit
    def step(arrs, f, forced_mask, forced_val, penalty):
        return smapped(
            arrs["cells_xyz"], arrs["slot_map"], arrs["rhs_map"],
            arrs["ell_cols"], arrs["diag_slot"], arrs["send_idx"],
            arrs["halo_src"], f, forced_mask, forced_val, penalty,
        )

    return step


def stacked_node_mask(
    sp: ShardedProblem, nodes: np.ndarray, values: np.ndarray | float
) -> tuple[np.ndarray, np.ndarray]:
    """(P, N_own_max) mask/value arrays for a global node set (host)."""
    mask = np.zeros((sp.n_parts, sp.n_own_max), bool)
    val = np.zeros((sp.n_parts, sp.n_own_max), np.float64)
    vals = np.broadcast_to(np.asarray(values, np.float64), np.shape(nodes))
    # local index of each global node inside its owner
    loc = np.full(sp.n_nodes, -1, np.int64)
    for p in range(sp.n_parts):
        k = sp.n_own[p]
        loc[sp.owned_global[p, :k]] = np.arange(k)
    p_of = sp.part[nodes]
    mask[p_of, loc[nodes]] = True
    val[p_of, loc[nodes]] = vals
    return mask, val
