"""Distributed unstructured AMG-PCG under shard_map.

The Hypre role (reference femutils/HypreDoFLinearSystem.cc:264-303,686-742:
global numbering + distributed BoomerAMG-preconditioned PCG) rebuilt
over the RCB node partition:

* the FINE level — where virtually all V-cycle flops and bandwidth live —
  is sharded: Jacobi smoothing over the shard-assembled ELL rows, residuals
  through the existing all_gather halo SpMV;
* restriction ``r_c = P^T r`` is a per-shard segment-sum of owned rows into
  the replicated coarse vector followed by one ``psum`` (the reference's
  allReduce role);
* all COARSER levels are replicated: every device runs the identical
  (deterministic) inner V-cycle on its own copy — coarse grids are tiny,
  so duplicated flops are cheaper than the collectives they would need;
* prolongation is a static row-ELL gather from the replicated coarse
  correction back onto owned rows.

Setup (strength/aggregation/Galerkin) stays host-side in solver/amg.py's
``build_amg`` on the globally assembled matrix; this module re-partitions
its fine level and re-wraps the rest as the replicated inner cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..solver.amg import AMGPrecond
from .partition import ShardedProblem
from .sharded import (
    AXIS,
    shard_assemble,
    shard_source_rhs,
    shard_spmv,
    shard_pcg,
)


@dataclass
class ShardedAMG:
    """Host-built partition of an AMGPrecond hierarchy (see build_sharded_amg)."""

    inv_diag0: np.ndarray  # (P, N_own_max) fine inverse diagonal, 0 on pad
    pcols0: np.ndarray  # (P, N_own_max, Wp) coarse GLOBAL ids, pad -> n1
    pvals0: np.ndarray  # (P, N_own_max, Wp) 0.0 on padding
    n1: int  # coarse-space size of the first transfer
    omega0: float
    nu: int
    inner: AMGPrecond  # levels 1.. (replicated); may have 0 mats (dense only)


def build_sharded_amg(sp: ShardedProblem, amg: AMGPrecond) -> ShardedAMG:
    """Partition the fine level of a host-built AMG hierarchy by sp's rows."""
    inv0 = np.asarray(amg.inv_diags[0])
    pc0 = np.asarray(amg.pcols[0])
    pv0 = np.asarray(amg.pvals[0])
    # amg.mats[0] is the FINE matrix; the coarse size of transfer 0 is the
    # row count of level 1 (mats[1] if present, else the dense coarsest)
    n1 = (
        int(amg.mats[1].topo.n_nodes)
        if len(amg.mats) > 1
        else int(np.asarray(amg.coarse_inv).shape[0])
    )
    P, N = sp.n_parts, sp.n_own_max
    Wp = pc0.shape[1]
    inv_diag0 = np.zeros((P, N), inv0.dtype)
    pcols0 = np.full((P, N, Wp), n1, np.int32)
    pvals0 = np.zeros((P, N, Wp), pv0.dtype)
    for p in range(P):
        k = sp.n_own[p]
        own = sp.owned_global[p, :k]
        inv_diag0[p, :k] = inv0[own]
        pcols0[p, :k] = pc0[own]
        pvals0[p, :k] = pv0[own]
    # zero-valued transfer entries keep their (arbitrary) column; route all
    # of them to the dump slot so segment sums stay clean
    pcols0 = np.where(pvals0 != 0.0, pcols0, n1).astype(np.int32)
    # the replicated inner hierarchy runs INSIDE shard_map on every device
    inner = replace(
        amg,
        mats=amg.mats[1:],
        inv_diags=amg.inv_diags[1:],
        pcols=amg.pcols[1:],
        pvals=amg.pvals[1:],
        ptcols=amg.ptcols[1:],
        ptvals=amg.ptvals[1:],
        omegas=amg.omegas[1:],
        # keep the per-level meta aligned with the stripped level too: a
        # chebyshev hierarchy reads rhos[l] inside the inner cycle
        rhos=amg.rhos[1:] if amg.rhos else (),
        # per-level chebyshev degree tuples shift down with the levels
        cheb_deg=(amg.cheb_deg[1:] or amg.cheb_deg[-1:])
        if isinstance(amg.cheb_deg, (tuple, list)) else amg.cheb_deg,
    )
    return ShardedAMG(
        inv_diag0=inv_diag0,
        pcols0=pcols0,
        pvals0=pvals0,
        n1=n1,
        omega0=float(amg.omegas[0]),
        nu=int(amg.nu),
        inner=inner,
    )


def fine_vcycle(spmv, inv_diag0, pcols0, pvals0, inner: AMGPrecond,
                n1: int, omega0: float, nu: int, r):
    """Sharded fine level (smooth/restrict/prolong) around the replicated
    inner hierarchy."""
    om = jnp.asarray(omega0, r.dtype)
    x = om * inv_diag0 * r
    for _ in range(nu - 1):
        x = x + om * inv_diag0 * (r - spmv(x))
    rr = r - spmv(x)
    rc_part = jax.ops.segment_sum(
        (pvals0 * rr[:, None]).reshape(-1),
        pcols0.reshape(-1),
        num_segments=n1 + 1,
    )[:-1]
    rc = jax.lax.psum(rc_part, AXIS)
    xc = inner.apply(rc)
    x = x + jnp.einsum("nw,nw->n", pvals0, xc[pcols0])
    for _ in range(nu):
        x = x + om * inv_diag0 * (r - spmv(x))
    return x


def make_poisson_amg_step(
    sp: ShardedProblem,
    mesh: jax.sharding.Mesh,
    samg: ShardedAMG,
    rtol: float = 1.0e-7,
    atol: float = 0.0,
    max_iter: int = 200,
):
    """Jitted sharded Poisson step preconditioned by the distributed AMG
    V-cycle.  Same calling convention as sharded.make_poisson_step.
    """
    n_own_max, width = sp.n_own_max, sp.width
    n1, omega0, nu = samg.n1, samg.omega0, samg.nu
    pspec = jax.sharding.PartitionSpec(AXIS)
    repl = jax.sharding.PartitionSpec()

    def shard_fn(
        cells_xyz, slot_map, rhs_map, ell_cols, diag_slot,
        send_idx, halo_src, inv_diag0, pcols0, pvals0, inner,
        f, forced_mask, forced_val, penalty,
    ):
        (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
         halo_src, inv_diag0, pcols0, pvals0, forced_mask,
         forced_val) = jax.tree.map(
            lambda a: a[0],
            (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
             halo_src, inv_diag0, pcols0, pvals0, forced_mask, forced_val),
        )
        values = shard_assemble(cells_xyz, slot_map, n_own_max, width)
        rhs = shard_source_rhs(cells_xyz, rhs_map, n_own_max, f)

        flat = values.reshape(-1)
        dvals = jnp.where(forced_mask, penalty, flat[diag_slot])
        values = flat.at[diag_slot].set(dvals).reshape(n_own_max, width)
        rhs = jnp.where(forced_mask, penalty * forced_val, rhs)
        x0 = jnp.where(forced_mask, forced_val, 0.0).astype(rhs.dtype)

        def spmv(x):
            return shard_spmv(values, ell_cols, x, send_idx, halo_src)

        def vcycle(r):
            # fine level sharded: pre-smooth, restrict (psum), replicated
            # inner cycle, prolongate, post-smooth
            return fine_vcycle(spmv, inv_diag0, pcols0, pvals0, inner,
                               n1, omega0, nu, r)

        x, iters, res = shard_pcg(spmv, vcycle, rhs, x0, rtol, atol, max_iter)
        return x[None], iters, res

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            {k: pspec for k in sp.cells_xyz},
            {k: pspec for k in sp.slot_map},
            {k: pspec for k in sp.rhs_map},
            pspec, pspec, pspec, pspec,
            pspec, pspec, pspec, repl,
            repl, pspec, pspec, repl,
        ),
        out_specs=(pspec, repl, repl),
        check_vma=False,
    )

    @jax.jit
    def step(arrs, samg_arrs, inner, f, forced_mask, forced_val, penalty):
        return smapped(
            arrs["cells_xyz"], arrs["slot_map"], arrs["rhs_map"],
            arrs["ell_cols"], arrs["diag_slot"], arrs["send_idx"],
            arrs["halo_src"], samg_arrs["inv_diag0"], samg_arrs["pcols0"],
            samg_arrs["pvals0"], inner, f, forced_mask, forced_val, penalty,
        )

    return step


def put_sharded_amg(samg: ShardedAMG, mesh: jax.sharding.Mesh, dtype):
    """Device placement for the sharded fine-level AMG arrays."""
    P = jax.sharding.PartitionSpec
    shard = jax.sharding.NamedSharding(mesh, P(AXIS))
    return {
        "inv_diag0": jax.device_put(
            samg.inv_diag0.astype(dtype), shard
        ),
        "pcols0": jax.device_put(samg.pcols0, shard),
        "pvals0": jax.device_put(samg.pvals0.astype(dtype), shard),
    }
