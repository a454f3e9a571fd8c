"""AMG convergence-rate lab on the bench's exact unstructured system (CPU).

Iteration count is platform-independent: the matrix, preconditioner and
stopping criterion are identical math on the CPU and the GPU, so every
PCG iteration shaved here is a direct multiple of the per-iteration cost
the GPU benchmark measures; this lab settles the *iteration count*, the
chip settles the *cost per iteration*.

Builds the system of problems.py (sphere_cut through the tools' mesh
cache, utils/cache.py): penalty Dirichlet Cut=0 / sphere=1, unit source
rhs, warm-started x0, preconditioned-norm rtol 1e-8 — the reference
pipeline being raced is CUDA BSR assembly (femutils/BSRFormat.h:842-898)
+ Hypre BoomerAMG-PCG (femutils/HypreDoFLinearSystem.cc:686-742), whose
roofline model assumes 14 iterations (BASELINE.md).

Usage:
  python tools/conv_tune.py --h 5 --refine 1 --configs default,cheb3,bf16

Results append to <cache dir>/conv_tune.jsonl and print as a table.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from arcanefem_tpu.utils import device
from arcanefem_tpu.utils.cache import CACHE_DIR, cache_path

import jax

device.setup(cpu=True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def build_system(h: float, refine: int, dtype, penalty: float,
                 bc: str = "penalty", diag_scale: bool = False):
    """The bench's exact finalized system (A, b, x0) + raw topology.

    bc="elim": symmetric row+column elimination instead of penalty rows
    (DoFLinearSystem's RowColumnElimination semantics) — keeps the matrix
    SPD with O(1) entry scales, which matters in f32: the 8.9M system
    needs 55 PCG iterations with penalty rows in f32 but 6 in f64 — the
    growth is a precision artifact of the mixed 1e12/interior scales.
    diag_scale: symmetric Jacobi scaling D^-1/2 A D^-1/2 (solve for
    y = D^1/2 x), normalizing representation scales for f32."""
    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.sparse.bell import BellMatrix
    from arcanefem_tpu.utils.cache import sphere_cut_cached

    t0 = time.time()
    mesh, topo = sphere_cut_cached(h, refine)
    key = f"sphere_cut_h{h:g}_r{refine}"
    print(f"[tune] mesh {mesh.n_nodes:,} nodes, topo W={topo.width} "
          f"nnz={topo.nnz:,} ({time.time()-t0:.1f}s)", file=sys.stderr)

    n, W = topo.n_nodes, topo.width
    coords = jnp.asarray(mesh.coords.astype(np.float32))
    t0 = time.time()
    asm = TetraLaneAssembler(topo, mesh.cells["tetra4"])
    vals = np.asarray(asm(coords))
    print(f"[tune] assembled ({time.time()-t0:.1f}s)", file=sys.stderr)

    cut = np.unique(mesh.face_groups["Cut"]["tria3"])
    sph = np.unique(mesh.face_groups["sphere"]["tria3"])
    mask = np.zeros(n, bool)
    mask[cut] = True
    mask[sph] = True
    gv = np.zeros(n, np.float64)
    gv[sph] = 1.0

    pc = mesh.coords[mesh.cells["tetra4"]]
    vv = pc[:, 1:] - pc[:, :1]
    vols = np.abs(
        np.einsum("ij,ij->i", np.cross(vv[:, 0], vv[:, 1]), vv[:, 2])
    ) / 6.0
    rhs_np = np.zeros(n, np.float64)
    np.add.at(rhs_np, np.asarray(mesh.cells["tetra4"]).reshape(-1),
              np.repeat(vols / 4.0, 4))
    rhs_np = np.where(mask, penalty * gv, rhs_np)

    # f64 lab runs must store the penalty exactly: assembling in f32 then
    # setting a penalty the f32 grid can't represent while b carries the
    # exact f64 value leaves r0 = (f32(P) - P)·g ~ 1e22 on bc rows, which
    # inflates rz0 by ~5e10 and makes the relative criterion trivially
    # loose (the "6-iteration f64" artifact in the tuning log).
    flat = vals.reshape(-1).astype(np.float64)
    if bc == "elim":
        # symmetric row+column elimination (RowColumnElimination):
        # rhs_int -= A[:, bc]·g, zero bc rows+cols, unit bc diagonal,
        # rhs_bc = g.  SPD, O(1) scales — no penalty representation tax.
        ell = flat.reshape(n, W)
        cols = np.asarray(topo.ell_cols)
        valid = np.asarray(topo.ell_valid)
        g = np.where(mask, gv, 0.0)
        Ag = (ell * g[cols] * valid).sum(axis=1)
        rhs_np = np.zeros(n, np.float64)
        np.add.at(rhs_np, np.asarray(mesh.cells["tetra4"]).reshape(-1),
                  np.repeat(vols / 4.0, 4))
        rhs_np = np.where(mask, gv, rhs_np - Ag)
        dead = mask[:, None] | (mask[cols] & valid)
        ell = np.where(dead, 0.0, ell)
        flat = ell.reshape(-1)
        flat[np.asarray(topo.diag_slot)[mask]] = 1.0
    else:
        flat[np.asarray(topo.diag_slot)[mask]] = penalty

    scale = None
    if diag_scale:
        dvals = flat[np.asarray(topo.diag_slot)]
        s = 1.0 / np.sqrt(np.where(dvals > 0, dvals, 1.0))
        ell = flat.reshape(n, W)
        flat = (ell * s[:, None] * s[np.asarray(topo.ell_cols)]
                * np.asarray(topo.ell_valid)).reshape(-1)
        flat[np.asarray(topo.diag_slot)] = 1.0
        rhs_np = rhs_np * s
        scale = s

    A = BellMatrix(
        values=jnp.asarray(flat.reshape(n, W, 1, 1).astype(dtype)),
        topo=topo, block=1, cols=jnp.asarray(topo.ell_cols),
    )
    b = jnp.asarray(rhs_np.astype(dtype))
    x0_np = np.where(mask, gv, 0.0)
    if scale is not None:
        x0_np = x0_np / scale  # y = D^1/2 x
    x0 = jnp.asarray(x0_np.astype(dtype))
    if bc != "penalty":
        key += f"_{bc}"
    if diag_scale:
        key += "_dscale"
    return A, b, x0, key


def quantize_vcycle(M):
    """bf16-precision V-cycle: round-trip the level values and transfers
    through bfloat16 (the Krylov operator A stays full precision)."""
    from dataclasses import replace

    def q(m):
        v = m.values.astype(jnp.bfloat16).astype(m.values.dtype)
        return m.with_values(v.reshape(v.shape[0], -1))

    return replace(
        M,
        mats=tuple(q(m) for m in M.mats),
        pvals=tuple(p.astype(jnp.bfloat16).astype(p.dtype)
                    for p in M.pvals),
        ptvals=tuple(p.astype(jnp.bfloat16).astype(p.dtype)
                     for p in M.ptvals),
    )


def run_config(A, b, x0, key, name, rtol, max_iter, bf16=False,
               pair=False, **amg_kw):
    import pickle
    from dataclasses import replace

    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.solver.iterative import pcg

    # the hierarchy (mats/transfers/omegas/rhos) depends only on the
    # STRUCTURAL knobs — smoother/cheb_deg/nu are pure apply-time meta, so
    # one cached setup serves every smoother config at that theta/trunc
    structural = {k: v for k, v in amg_kw.items()
                  if k in ("theta", "trunc_kmax", "trunc_rel",
                           "coarse_size", "max_levels", "omega")}
    meta = {k: v for k, v in amg_kw.items() if k not in structural}
    cfg_key = "_".join(f"{k}-{v}" for k, v in sorted(structural.items()))
    dt = np.dtype(np.asarray(A.values).dtype).name  # hierarchy dtype
    # v2: rho_est Lanczos+Gershgorin fix changes every hierarchy
    path = f"{CACHE_DIR}/tune2_{key}_{dt}_{cfg_key}.pkl"
    t0 = time.time()
    if os.path.exists(path):
        with open(path, "rb") as f:
            M = pickle.load(f)
        cached = True
    else:
        M = build_amg(A, **structural)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(M, f, protocol=4)
        os.replace(path + ".tmp", path)
        cached = False
    if meta:
        M = replace(M, **meta)
    setup_s = time.time() - t0
    if bf16:
        M = quantize_vcycle(M)

    t0 = time.time()
    if pair == "flex":
        from arcanefem_tpu.solver.iterative import pcg_flex

        x, iters, res = pcg_flex(A, b, M, x0, rtol, 0.0, max_iter)
    elif pair:
        from arcanefem_tpu.solver.iterative import pcg_pair

        x, iters, res = pcg_pair(A, b, M, x0, rtol, 0.0, max_iter)
    else:
        # compensated dots, exactly as the bench's solve (bench.py pcg)
        x, iters, res = pcg(A, b, M, x0, rtol, 0.0, max_iter,
                            use_precise_dot=True)
    iters = int(iters)
    solve_s = time.time() - t0
    true_res = float(jnp.linalg.norm(b - A.spmv(x)) / jnp.linalg.norm(b))

    # V-cycle fine-SpMV-equivalent cost model (what the iteration count
    # multiplies on the device): per level, pre-smooth (deg_l-1 SpMVs) + residual
    # (1) + post-smooth (deg_l) = 2·deg_l SpMVs, weighted by level nnz.
    w0 = float(np.asarray(M.mats[0].values).size)
    wts = [float(np.asarray(m.values).size) / w0 for m in M.mats]
    opc = sum(wts)
    smoother = amg_kw.get("smoother", "jacobi")
    deg = amg_kw.get("cheb_deg", 2) if smoother == "chebyshev" else \
        amg_kw.get("nu", 1)

    def deg_l(l):
        if isinstance(deg, (tuple, list)):
            return deg[min(l, len(deg) - 1)]
        return deg

    wcyc = amg_kw.get("cycle", "V") == "W"
    cycle = sum(2.0 * deg_l(l) * w * ((2 ** l) if (wcyc and l) else 1)
                for l, w in enumerate(wts))
    cost = iters * (1.0 + cycle)  # Krylov fine SpMV + cycle work

    row = {
        "name": name, "key": key, "iters": iters,
        "rel_cost": round(cost, 1),
        "true_residual": f"{true_res:.2e}",
        "monitored": f"{float(res):.2e}",
        "levels": [m.topo.n_nodes for m in M.mats],
        "op_complexity": round(opc, 3),
        "setup_s": round(setup_s, 1), "setup_cached": cached,
        "solve_s": round(solve_s, 1), "bf16": bf16, "pair": pair, **amg_kw,
    }
    print(json.dumps(row), flush=True)
    with open(cache_path("conv_tune.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


CONFIGS = {
    # bench default today
    "default": dict(smoother="chebyshev", cheb_deg=2),
    "cheb3": dict(smoother="chebyshev", cheb_deg=3),
    "cheb4": dict(smoother="chebyshev", cheb_deg=4),
    "jacobi": dict(smoother="jacobi"),
    "jacobi2": dict(smoother="jacobi", nu=2),
    "bf16": dict(smoother="chebyshev", cheb_deg=2, bf16=True),
    # stronger strength threshold: sparser P, cheaper cycle, maybe more iters
    "theta12": dict(smoother="chebyshev", cheb_deg=2, theta=0.12),
    "theta05": dict(smoother="chebyshev", cheb_deg=2, theta=0.05),
    "theta03": dict(smoother="chebyshev", cheb_deg=2, theta=0.03),
    "theta02": dict(smoother="chebyshev", cheb_deg=2, theta=0.02),
    "theta05c3": dict(smoother="chebyshev", cheb_deg=3, theta=0.05),
    "theta05bf16": dict(smoother="chebyshev", cheb_deg=2, theta=0.05,
                        bf16=True),
    "theta05j": dict(smoother="jacobi", theta=0.05),
    # per-level chebyshev degree: stronger smoothing on the cheap coarse
    # levels (2·deg_l·w_l extra SpMV work, w_l ~ 0.1-0.3) to restore
    # iteration scalability at 10M (64 iters with uniform deg 2)
    "t03deg24": dict(smoother="chebyshev", cheb_deg=(2, 4), theta=0.03),
    "t03deg26": dict(smoother="chebyshev", cheb_deg=(2, 6), theta=0.03),
    "t03deg34": dict(smoother="chebyshev", cheb_deg=(3, 4), theta=0.03),
    "t05deg24": dict(smoother="chebyshev", cheb_deg=(2, 4), theta=0.05),
    # pair-precision PCG (x, r as double-f32): kills the f32 noise grind
    "t03pair": dict(smoother="chebyshev", cheb_deg=2, theta=0.03,
                    pair=True),
    "pairdflt": dict(smoother="chebyshev", cheb_deg=2, pair=True),
    # flexible PCG (Polak-Ribière beta): robust to the f32 V-cycle's
    # input-dependent rounding (a slightly varying preconditioner)
    "t03flex": dict(smoother="chebyshev", cheb_deg=2, theta=0.03,
                    pair="flex"),
    # W-cycle: second visit per coarse level (cheap; coarse-grid
    # correction quality compounds) — the 10M iteration-growth fix probe
    "t03w": dict(smoother="chebyshev", cheb_deg=2, theta=0.03, cycle="W"),
    "t03wdeg24": dict(smoother="chebyshev", cheb_deg=(2, 4), theta=0.03,
                      cycle="W"),
    "defaultw": dict(smoother="chebyshev", cheb_deg=2, cycle="W"),
    # prolongator truncation: wider P = better rate, costlier cycle
    "trunc12": dict(smoother="chebyshev", cheb_deg=2, trunc_kmax=12),
    "trunc6": dict(smoother="chebyshev", cheb_deg=2, trunc_kmax=6,
                   trunc_rel=0.08),
    "sawtooth": dict(smoother="chebyshev", cheb_deg=2, sawtooth=True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=5.0)
    ap.add_argument("--refine", type=int, default=1)
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--penalty", type=float, default=1e12,
                    help="the bench uses 1e12 (f32)")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--configs", default="default,cheb3,jacobi,bf16")
    ap.add_argument("--bc", default="penalty", choices=["penalty", "elim"])
    ap.add_argument("--diag-scale", action="store_true")
    args = ap.parse_args()

    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    A, b, x0, key = build_system(args.h, args.refine, dtype, args.penalty,
                                 bc=args.bc, diag_scale=args.diag_scale)

    rows = []
    for name in args.configs.split(","):
        kw = dict(CONFIGS[name])
        bf16 = kw.pop("bf16", False)
        pair = kw.pop("pair", False)
        rows.append(run_config(A, b, x0, key, name, args.rtol,
                               args.max_iter, bf16=bf16, pair=pair, **kw))

    rows.sort(key=lambda r: r["rel_cost"])
    print(f"{'config':<10} {'iters':>5} {'rel_cost':>8} {'opc':>6} "
          f"{'true_res':>9}")
    for r in rows:
        print(f"{r['name']:<10} {r['iters']:>5} {r['rel_cost']:>8} "
              f"{r['op_complexity']:>6} {r['true_residual']:>9}")


if __name__ == "__main__":
    main()
