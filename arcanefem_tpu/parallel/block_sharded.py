"""Sharded block (ndof > 1) systems: elasticity under shard_map.

The JAX counterpart of the reference's distributed vector problems:
elasticity assembles ``BSRFormat<2>`` blocks and solves under MPI
(modules/elasticity/FemModule.cc:146-195, CMakeLists.txt mpirun tests).
Here the *same node partition* as the scalar path (parallel/partition.py
RCB + recompute-overlap) carries (b, b) blocks: topology is node-based, so
``ShardedProblem`` is reused unchanged — only values, right-hand sides and
Dirichlet masks grow a trailing dof dimension.

Per-shard layout:

* values   (N_own_max, W, b, b)   block ELL over owned rows
* x        (N_loc, b)             [owned | halo] node-major
* SpMV     einsum("nwab,nwb->na") after the all_gather halo exchange
* Dirichlet: per-dof mask (N_own_max, b); penalty writes the (c, c) diag
  entry of the owned diagonal block (HypreDoFLinearSystem.cc:356-382 role)
* dots     psum over the device axis (reference: IParallelMng::reduce)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import elements
from .partition import ShardedProblem
from .sharded import AXIS, pdot, shard_pcg

__all__ = [
    "shard_assemble_blocks",
    "shard_halo_block",
    "shard_spmv_block",
    "make_elasticity_step",
    "stacked_dof_mask",
]


def shard_assemble_blocks(cells_xyz, slot_map, n_own_max, width, kernel, b):
    """Element block kernels + segment-sum into (N_own_max, W, b, b)."""
    n_slots = n_own_max * width + 1  # +1 dump slot
    acc = None
    for name in cells_xyz:
        ke = kernel(name, cells_xyz[name])  # (nc, npc, npc, b, b)
        part = jax.ops.segment_sum(
            ke.reshape(-1, b, b),
            slot_map[name].reshape(-1),
            num_segments=n_slots,
        )
        acc = part if acc is None else acc + part
    return acc[:-1].reshape(n_own_max, width, b, b)


def shard_halo_block(x_own, send_idx, halo_src):
    """(N_own_max, b) owned values -> (N_loc, b) [owned | halo]."""
    pool = jax.lax.all_gather(x_own[send_idx], AXIS)  # (P, S_max, b)
    b = x_own.shape[-1]
    return jnp.concatenate([x_own, pool.reshape(-1, b)[halo_src]])


def shard_spmv_block(values, ell_cols, x_own, send_idx, halo_src):
    x_loc = shard_halo_block(x_own, send_idx, halo_src)
    return jnp.einsum("nwab,nwb->na", values, x_loc[ell_cols])


def shard_vector_source(cells_xyz, rhs_map, n_own_max, f):
    """rhs[node, c] += f[c] * measure / npc (constant body force,
    the reference's bodyforce option, elasticity FemModule.cc:221-272)."""
    b = f.shape[0]
    acc = jnp.zeros((n_own_max + 1, b), list(cells_xyz.values())[0].dtype)
    for name in cells_xyz:
        meas = elements.measure(name, cells_xyz[name])  # (nc,)
        npc = rhs_map[name].shape[-1]
        contrib = jnp.repeat(meas / npc, npc)[:, None] * f[None, :]
        acc = acc + jax.ops.segment_sum(
            contrib, rhs_map[name].reshape(-1), num_segments=n_own_max + 1
        )
    return acc[:-1]


def apply_penalty_blocks(values, diag_slot, forced_mask, penalty):
    """Write penalty on the (c, c) diagonal entries of forced dofs.

    values (N_own_max, W, b, b); forced_mask (N_own_max, b) bool.
    """
    n_own_max, width, b, _ = values.shape
    flat = values.reshape(-1, b, b)
    dblk = flat[diag_slot]  # (N_own_max, b, b)
    eye = jnp.eye(b, dtype=values.dtype)
    dblk = jnp.where(
        (forced_mask[:, :, None] & (eye[None] > 0)),
        penalty,
        dblk,
    )
    return flat.at[diag_slot].set(dblk).reshape(n_own_max, width, b, b)


def make_elasticity_step(
    sp: ShardedProblem,
    mesh: jax.sharding.Mesh,
    lam: float,
    mu2: float,
    rtol: float = 1.0e-7,
    atol: float = 0.0,
    max_iter: int = 1000,
    ndof: int = 2,
):
    """Jitted sharded elasticity step: block assembly + penalty BC + PCG.

    fn(arrs, f, forced_mask, forced_val, penalty) -> (x, iters, res) with
    x (P, N_own_max, b) sharded; forced_mask/val (P, N_own_max, b) stacked
    per-dof penalty-Dirichlet data (host-built via ``stacked_dof_mask``).
    ``f`` is the (b,) constant body force.
    """
    n_own_max, width, b = sp.n_own_max, sp.width, ndof
    pspec = jax.sharding.PartitionSpec(AXIS)

    def kernel(name, xyz):
        if name == "tria3":
            return elements.elasticity_tria3(xyz, lam, mu2)
        if name == "tetra4":
            return elements.elasticity_tetra4(xyz, lam, mu2)
        raise ValueError(f"no elasticity kernel for '{name}'")

    def shard_fn(
        cells_xyz, slot_map, rhs_map, ell_cols, diag_slot,
        send_idx, halo_src, f, forced_mask, forced_val, penalty,
    ):
        (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
         halo_src, forced_mask, forced_val) = jax.tree.map(
            lambda a: a[0],
            (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
             halo_src, forced_mask, forced_val),
        )
        values = shard_assemble_blocks(
            cells_xyz, slot_map, n_own_max, width, kernel, b
        )
        rhs = shard_vector_source(cells_xyz, rhs_map, n_own_max, f)

        values = apply_penalty_blocks(values, diag_slot, forced_mask, penalty)
        rhs = jnp.where(forced_mask, penalty * forced_val, rhs)

        dblk = values.reshape(-1, b, b)[diag_slot]
        d = jnp.einsum("ncc->nc", dblk.reshape(n_own_max, b, b))
        inv_diag = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)
        x0 = jnp.where(forced_mask, forced_val, 0.0).astype(rhs.dtype)

        def spmv(x):
            return shard_spmv_block(values, ell_cols, x, send_idx, halo_src)

        x, iters, res = shard_pcg(
            spmv, inv_diag, rhs, x0, rtol, atol, max_iter
        )
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


def make_elastodynamics_loop(
    sp: ShardedProblem,
    mesh: jax.sharding.Mesh,
    coeffs: dict,
    gamma: float,
    beta: float,
    dt: float,
    n_steps: int,
    rtol: float = 1.0e-10,
    atol: float = 0.0,
    max_iter: int = 2000,
    ndof: int = 2,
):
    """Sharded transient elastodynamics: the reference's synchronize()-per-
    step Newmark loop (modules/elastodynamics/FemModule.cc:429+) as ONE
    jitted shard_map program.

    Device-first inversion mirroring models/elastodynamics: the three unit
    operators M (mass), D (divdiv), E (epseps) are assembled once per shard
    over the frozen sparsity, the LHS is c0·M + c1·D + c2·E with penalty
    Dirichlet written once, and a ``lax.scan`` over ``n_steps`` rebuilds
    only the RHS (three halo-exchanged block SpMVs), solves with the
    distributed PCG warm-started at the previous displacement, and applies
    the Newmark update — the halo exchange inside the SpMVs is the
    ``synchronize()`` of the reference's loop.

    Returns fn(arrs, f, forced_mask, forced_val, penalty) ->
    (U, V, A, iters_total) with (P, N_own_max, b) sharded states.
    """
    n_own_max, width, b = sp.n_own_max, sp.width, ndof
    pspec = jax.sharding.PartitionSpec(AXIS)
    c = coeffs
    mass_c = (c["c0"], c["c3"], c["c4"])
    div_c = (-c["c5"], c["c7"], c["c8"])
    eps_c = (-c["c6"], c["c9"], c["c10"])

    def shard_fn(
        cells_xyz, slot_map, rhs_map, ell_cols, diag_slot,
        send_idx, halo_src, f, forced_mask, forced_val, penalty,
    ):
        (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
         halo_src, forced_mask, forced_val) = jax.tree.map(
            lambda a: a[0],
            (cells_xyz, slot_map, rhs_map, ell_cols, diag_slot, send_idx,
             halo_src, forced_mask, forced_val),
        )
        asm = lambda k: shard_assemble_blocks(
            cells_xyz, slot_map, n_own_max, width, k, b
        )
        Mv = asm(lambda ct, xyz: elements.mass_blocks(ct, xyz, b))
        Dv = asm(elements.divdiv)
        Ev = asm(elements.epseps)
        Av = c["c0"] * Mv + c["c1"] * Dv + c["c2"] * Ev
        Av = apply_penalty_blocks(Av, diag_slot, forced_mask, penalty)

        rhs_body = shard_vector_source(cells_xyz, rhs_map, n_own_max, f)

        dblk = Av.reshape(-1, b, b)[diag_slot]
        d = jnp.einsum("ncc->nc", dblk)
        inv_diag = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

        def spmv_of(vals):
            return lambda x: shard_spmv_block(
                vals, ell_cols, x, send_idx, halo_src
            )

        A_mv, M_mv, D_mv, E_mv = (
            spmv_of(Av), spmv_of(Mv), spmv_of(Dv), spmv_of(Ev)
        )

        def one_step(carry, _):
            U, V, Acc, it_tot = carry
            rhs = rhs_body
            rhs = rhs + M_mv(mass_c[0] * U + mass_c[1] * V + mass_c[2] * Acc)
            rhs = rhs + D_mv(div_c[0] * U + div_c[1] * V + div_c[2] * Acc)
            rhs = rhs + E_mv(eps_c[0] * U + eps_c[1] * V + eps_c[2] * Acc)
            rhs = jnp.where(forced_mask, penalty * forced_val, rhs)
            x0 = jnp.where(forced_mask, forced_val, U)
            dU, it, _res = shard_pcg(
                A_mv, inv_diag, rhs, x0, rtol, atol, max_iter
            )
            aloc = (
                (dU - U - dt * V) / (beta * dt * dt)
                - (1 - 2 * beta) / (2 * beta) * Acc
            )
            Vn = V + dt * ((1 - gamma) * Acc + gamma * aloc)
            return (dU, Vn, aloc, it_tot + it), None

        U0 = jnp.where(forced_mask, forced_val, 0.0).astype(rhs_body.dtype)
        V0 = jnp.zeros_like(U0)
        A0 = jnp.zeros_like(U0)
        (U, V, Acc, iters), _ = jax.lax.scan(
            one_step, (U0, V0, A0, jnp.int32(0)), None, length=n_steps
        )
        return U[None], V[None], Acc[None], iters

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
        out_specs=(pspec, pspec, pspec, repl),
        check_vma=False,
    )

    @jax.jit
    def run(arrs, f, forced_mask, forced_val, penalty):
        return smapped(
            arrs["cells_xyz"], arrs["slot_map"], arrs["rhs_map"],
            arrs["ell_cols"], arrs["diag_slot"], arrs["send_idx"],
            arrs["halo_src"], f, forced_mask, forced_val, penalty,
        )

    return run


def stacked_dof_mask(
    sp: ShardedProblem,
    ndof: int,
    node_sets: list[tuple[np.ndarray, int, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """(P, N_own_max, b) mask/value arrays from (nodes, comp, value) sets."""
    mask = np.zeros((sp.n_parts, sp.n_own_max, ndof), bool)
    val = np.zeros((sp.n_parts, sp.n_own_max, ndof), np.float64)
    loc = np.full(sp.n_nodes, -1, np.int64)
    for p in range(sp.n_parts):
        k = sp.n_own[p]
        loc[sp.owned_global[p, :k]] = np.arange(k)
    for nodes, comp, value in node_sets:
        nodes = np.asarray(nodes)
        p_of = sp.part[nodes]
        mask[p_of, loc[nodes], comp] = True
        val[p_of, loc[nodes], comp] = value
    return mask, val
