"""Smoke test of the GPU path: the main pipelines once, at full width.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One process drives the card.  Default phases:

1. card — name and power limit (nvidia-smi, from a child that never
   imports JAX), JAX devices and version;
2. unstructured, 1.9M DoF sphere_cut (h=5, refine=2), f32 — mesh, node
   order, topology and AMG set up cold from the seed; assembly compared
   with an independent float64 numpy/scipy assembly; BELL SpMV compared
   with scipy CSR; AMG-PCG to rtol 1e-8 with the true residual recomputed
   on the host in float64;
3. the same system in fp64 on the card, reusing the host AMG setup;
4. structured 224³ box (11.4M DoF), f32 — DIA assembly compared with a
   float64 numpy stencil assembly, DIA SpMV compared with scipy CSR,
   geometric-MG PCG to rtol 1e-8;
5. the assembly lab (``testlab --box 100 --cross-validate``): every format
   agrees.

``--four`` runs only the paths across cards: sharded AMG-PCG on the 1.9M
sphere_cut (RCB partition) and the x-slab sharded MG at 224³, each
compared with its one-card solve on device 0.  Both run in fp64, the
reference's own solve precision, so the comparison sees the partition and
not f32 rounding.

The script refuses to run without a GPU.  Any failed check raises, so the
exit code is non-zero and the JSON line below is not printed.  The last
line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# --- tolerances ------------------------------------------------------------
# SpMV: max_i |y_i - (Ax)_i| / (|A||x|)_i, the backward-error bound of a
# sum of ~W products: f32 unit roundoff 6e-8 times a few dozen terms stays
# below 1e-5, while a TF32 contraction (10-bit mantissa) lands near 1e-3.
SPMV_TOL = {np.float32: 1e-5, np.float64: 1e-12}
# assembly: max |got - ref| over each row's largest |ref| entry.  The f32
# device assembly starts from the same f32-rounded coordinates as the f64
# reference, so only f32 arithmetic (cofactor products, ~16-24 atomic
# adds per slot in run-dependent order) separates them.
ASM_TOL = 1e-5
# solve: ||b - Ax|| over the free (non-Dirichlet) rows relative to the
# warm start's, recomputed in f64 against the system the device solved
# (the full-system ||b-Ax||/||b|| is printed too, but the penalty rows'
# 1e12 entries dominate it).  rtol 1e-8 is on the preconditioned norm.
# Measured on the 244k sphere_cut system (CPU, same code): f32 PCG with
# compensated dots floors at 4.1e-5 whatever the rtol, f64 reaches 3.7e-8;
# the floor grows slowly with size (~n^(1/6)).
SOLVE_TOL = {np.float32: 5e-4, np.float64: 1e-6}
# the earlier rounds counted 24 AMG-PCG iterations at 1.9M to 1e-8;
# atomics reorder sums, which can move the count by one
EXPECT_ITERS_1_9M = 24
ITERS_SLACK = 2
# sharded vs one-card fp64 solutions, both to rtol 1e-10 (each monitored
# residual checked): max|x_sharded - x_one| / max|x_one|.  The two solves
# stop at different iterates of differently preconditioned systems; on
# 4x H100 they agreed to 2.2e-10 (AMG, 1.9M) and 3.8e-10 (MG, 224^3), so
# 1e-8 leaves a 26x margin while a solve stopped short of rtol fails it.
SHARDED_TOL = 1e-8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def log_peak(phase: str) -> None:
    from arcanefem_tpu.utils.device import peak_bytes

    pb = peak_bytes()
    log(f"[{phase}] device peak memory: "
        + ("not reported" if pb is None else f"{pb / 2**30:.3f} GiB"))


# --- host references (float64, numpy/scipy) --------------------------------

def tetra_gradients(p: np.ndarray):
    """(nc, 4, 3) corners -> (P1 gradients (nc, 4, 3), volumes (nc,)).

    With edge rows e_k = p_k - p_0, the columns of E^-1 — the gradients of
    the barycentric coordinates 1..3 — are (e2×e3, e3×e1, e1×e2) / det E.
    """
    e1, e2, e3 = (p[:, k] - p[:, 0] for k in (1, 2, 3))
    c = np.stack([np.cross(e2, e3), np.cross(e3, e1), np.cross(e1, e2)],
                 axis=1)
    det = np.einsum("ci,ci->c", e1, c[:, 0])
    g = np.empty_like(p)
    g[:, 1:] = c / det[:, None, None]
    g[:, 0] = -g[:, 1:].sum(axis=1)
    return g, np.abs(det) / 6.0


def reference_stiffness(coords: np.ndarray, conn: np.ndarray):
    """P1 tetra stiffness in float64 as scipy CSR (duplicates summed),
    ke = V g gᵀ."""
    import scipy.sparse as sp

    g, vol = tetra_gradients(coords[conn])
    ke = vol[:, None, None] * np.einsum("cid,cjd->cij", g, g)
    n = len(coords)
    rows = np.repeat(conn, 4, axis=1).reshape(-1)
    cols = np.tile(conn, (1, 4)).reshape(-1)
    A = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def bell_csr(flat: np.ndarray, topo):
    """Scalar BELL values (flat n*W) as a float64 scipy CSR."""
    import scipy.sparse as sp

    data = np.asarray(flat, np.float64).reshape(-1)[topo.csr_to_ell]
    return sp.csr_matrix((data, topo.csr_cols, topo.row_ptr),
                         shape=(topo.n_nodes, topo.n_nodes))


def reference_structured_bands(box, coords: np.ndarray) -> np.ndarray:
    """(15, n) float64 DIA bands of the Kuhn-tet box, by numpy slice-adds."""
    from arcanefem_tpu.mesh.structured import _HEX_CORNERS, _TETS

    nx, ny, nz = box.nx, box.ny, box.nz
    c = np.asarray(coords, np.float64)
    bands = {d: np.zeros((nx + 1, ny + 1, nz + 1)) for d in box.offsets}
    for tet in _TETS:
        p = np.stack([c[di:di + nx, dj:dj + ny, dk:dk + nz].reshape(-1, 3)
                      for di, dj, dk in (_HEX_CORNERS[k] for k in tet)],
                     axis=1)
        g, vol = tetra_gradients(p)
        for a, ca in enumerate(tet):
            di, dj, dk = _HEX_CORNERS[ca]
            for b, cb in enumerate(tet):
                d = box._lin(_HEX_CORNERS[cb]) - box._lin(_HEX_CORNERS[ca])
                bands[d][di:di + nx, dj:dj + ny, dk:dk + nz] += (
                    vol * (g[:, a] * g[:, b]).sum(axis=1)
                ).reshape(nx, ny, nz)
    return np.stack([bands[d].reshape(-1) for d in box.offsets])


def dia_csr(bands: np.ndarray, offsets):
    """(D, n) row-indexed DIA bands as a float64 scipy CSR."""
    import scipy.sparse as sp

    n = bands.shape[1]
    rows, cols, vals = [], [], []
    r = np.arange(n)
    for d, off in enumerate(offsets):
        ok = (r + off >= 0) & (r + off < n)
        rows.append(r[ok])
        cols.append(r[ok] + off)
        vals.append(np.asarray(bands[d], np.float64)[ok])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n))


def spmv_error(y: np.ndarray, A, x: np.ndarray) -> float:
    """max_i |y_i - (Ax)_i| / (|A||x|)_i with A a float64 scipy matrix."""
    x = np.asarray(x, np.float64)
    scale = abs(A) @ np.abs(x)
    err = np.abs(np.asarray(y, np.float64) - A @ x)
    return float((err / np.where(scale > 0, scale, 1.0)).max())


def row_scaled_error(got, ref) -> float:
    """max |got - ref| per row over the row's largest |ref| (CSR pair with
    the same pattern)."""
    diff = abs(got - ref).max(axis=1).toarray().ravel()
    scale = abs(ref).max(axis=1).toarray().ravel()
    return float((diff / np.where(scale > 0, scale, 1.0)).max())


def residuals(A, b, x, x0, mask) -> tuple[float, float]:
    """(||b-Ax||/||b||, free-row ||b-Ax|| over the warm start's)."""
    x = np.asarray(x, np.float64)
    r = b - A @ x
    r0 = b - A @ np.asarray(x0, np.float64)
    free = ~mask
    return (float(np.linalg.norm(r) / np.linalg.norm(b)),
            float(np.linalg.norm(r[free]) / np.linalg.norm(r0[free])))


# --- phases ----------------------------------------------------------------

def jit_spmv():
    """jitted (matrix, x) -> matrix.spmv(x)."""
    import jax

    return jax.jit(lambda A, v: A.spmv(v))


def phase_card() -> dict:
    import jax

    line = card_line()
    log(line)
    dev = jax.devices()[0]
    log(f"[card] jax {jax.__version__}, devices {jax.devices()}, "
        f"kind {dev.device_kind!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def phase_unstructured(h: float = 5.0, refine: int = 2, rtol: float = 1e-8,
                       expect_iters: int | None = EXPECT_ITERS_1_9M) -> dict:
    """f32 sphere_cut pipeline; returns the state the fp64 phase reuses."""
    import jax.numpy as jnp

    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.problems import (
        AMG_OPTIONS, bell_matrix, penalized_values, sphere_cut_mesh,
        sphere_cut_system,
    )
    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.solver.iterative import pcg
    from arcanefem_tpu.utils.native import library
    from arcanefem_tpu.utils.timing import time_call

    log("[unstr] native library: "
        + ("used" if library() is not None else "absent, numpy path"))
    mesh, topo, setup = sphere_cut_mesh(h, refine)
    n = topo.n_nodes
    conn = np.asarray(mesh.cells["tetra4"])
    log(f"[unstr] h={h:g} refine={refine}: {n:,} DoF, {len(conn):,} tets, "
        f"ELL width {topo.width}, {topo.nnz:,} stored nnz")
    for k, v in setup.items():
        log(f"[unstr] setup {k} {v:.2f}")

    coords32 = mesh.coords.astype(np.float32)
    asm = TetraLaneAssembler(topo, conn)
    vals, first, best = time_call(asm, jnp.asarray(coords32))
    log(f"[unstr] assembly compile+first {first:.2f} s, steady "
        f"{best * 1e3:.3f} ms ({n / best / 1e6:.1f} MDoF/s)")
    vals_np = np.asarray(vals)
    assert vals.dtype == jnp.float32 and vals_np.shape == (n, topo.width)
    assert np.isfinite(vals_np).all(), "non-finite assembled values"

    t0 = time.perf_counter()
    ref = reference_stiffness(coords32.astype(np.float64), conn)
    got = bell_csr(vals_np, topo)
    assert np.array_equal(ref.indptr, got.indptr) and np.array_equal(
        ref.indices, got.indices), "topology pattern != reference pattern"
    asm_err = row_scaled_error(got, ref)
    log(f"[unstr] assembly vs float64 scipy: row-scaled max error "
        f"{asm_err:.3e} (tol {ASM_TOL:g}; reference {time.perf_counter() - t0:.1f} s)")
    assert asm_err <= ASM_TOL, "assembly disagrees with the f64 reference"

    x = np.random.default_rng(0).random(n).astype(np.float32)
    A_raw = bell_matrix(vals_np.reshape(-1), topo, np.float32)
    y = np.asarray(jit_spmv()(A_raw, jnp.asarray(x)))
    sp_err = spmv_error(y, ref, x)
    log(f"[unstr] BELL SpMV f32 vs scipy CSR f64: {sp_err:.3e} "
        f"(tol {SPMV_TOL[np.float32]:g})")
    assert sp_err <= SPMV_TOL[np.float32], "BELL SpMV disagrees with scipy"
    del A_raw, ref, got

    system = sphere_cut_system(mesh)
    t0 = time.perf_counter()
    flat = penalized_values(vals_np, topo, system.mask)
    A = bell_matrix(flat, topo, np.float32)
    M = build_amg(A, values_np=flat, **AMG_OPTIONS)
    amg_s = time.perf_counter() - t0
    log(f"[unstr] setup amg_setup_s {amg_s:.2f} "
        f"({len(M.mats)} levels + coarse {M.coarse_inv.shape[0]})")
    del vals, asm

    b = jnp.asarray(system.rhs.astype(np.float32))
    x0 = jnp.asarray(system.x0.astype(np.float32))
    (xs, iters, res), first, best = time_call(
        lambda: pcg(A, b, M, x0, rtol, 0.0, 1000, use_precise_dot=True))
    iters = int(iters)
    assert xs.dtype == jnp.float32, f"f32 solve returned {xs.dtype}"
    A_sys = bell_csr(flat, topo)
    full, free = residuals(A_sys, np.asarray(b, np.float64), np.asarray(xs),
                           system.x0, system.mask)
    log(f"[unstr] f32 AMG-PCG: {iters} iterations, compile+first "
        f"{first:.2f} s, solve {best:.4f} s ({best / iters * 1e3:.3f} ms/iter), "
        f"monitored residual {float(res):.3e}")
    log(f"[unstr] f32 true residual (host f64): ||b-Ax||/||b|| {full:.3e}, "
        f"free rows {free:.3e} (tol {SOLVE_TOL[np.float32]:g})")
    assert float(res) <= rtol * 1.5, "monitored residual above rtol"
    assert free <= SOLVE_TOL[np.float32], "f32 true residual too large"
    if expect_iters is not None:
        assert abs(iters - expect_iters) <= ITERS_SLACK, (
            f"{iters} iterations, expected {expect_iters}±{ITERS_SLACK}")
    return {"topo": topo, "system": system, "flat": flat, "M": M,
            "A_sys": A_sys, "x32": np.asarray(xs), "iters32": iters}


def phase_fp64(state: dict, rtol: float = 1e-8,
               expect_iters: int | None = EXPECT_ITERS_1_9M) -> None:
    """The phase-2 system in fp64 on the card, same host AMG setup."""
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.problems import bell_matrix
    from arcanefem_tpu.solver.iterative import pcg
    from arcanefem_tpu.utils.timing import time_call

    system = state["system"]
    A = bell_matrix(state["flat"], state["topo"], np.float64)
    M = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, state["M"])
    b = jnp.asarray(system.rhs)
    x0 = jnp.asarray(system.x0)
    (x, iters, res), first, best = time_call(
        lambda: pcg(A, b, M, x0, rtol, 0.0, 1000))
    iters = int(iters)
    assert x.dtype == jnp.float64, f"fp64 solve returned {x.dtype}"
    full, free = residuals(state["A_sys"], system.rhs, np.asarray(x),
                           system.x0, system.mask)
    diff = float(np.abs(np.asarray(x) - state["x32"]).max())
    log(f"[fp64] AMG-PCG: {iters} iterations (f32: {state['iters32']}), "
        f"compile+first {first:.2f} s, solve {best:.4f} s "
        f"({best / iters * 1e3:.3f} ms/iter), monitored residual {float(res):.3e}")
    log(f"[fp64] true residual (host f64): ||b-Ax||/||b|| {full:.3e}, "
        f"free rows {free:.3e} (tol {SOLVE_TOL[np.float64]:g}); "
        f"max |x64 - x32| {diff:.3e}")
    assert float(res) <= rtol * 1.5, "monitored residual above rtol"
    assert free <= SOLVE_TOL[np.float64], "fp64 true residual too large"
    if expect_iters is not None:
        assert abs(iters - expect_iters) <= ITERS_SLACK, (
            f"{iters} iterations, expected {expect_iters}±{ITERS_SLACK}")


def phase_structured(n: int = 224, rtol: float = 1e-8) -> None:
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.problems import (
        PENALTY, structured_problem, structured_solver,
    )
    from arcanefem_tpu.sparse.dia import DiaMatrix
    from arcanefem_tpu.utils.timing import time_call

    p = structured_problem(n)
    box = p.box
    log(f"[box] {n}^3: {box.n_nodes:,} DoF, {box.n_cells:,} tets")
    c3d = jnp.asarray(p.coords)
    t0 = time.perf_counter()
    assemble = jax.jit(
        lambda c: box.assemble_stiffness(c).bands).lower(c3d).compile()
    compile_s = time.perf_counter() - t0
    bands, first, best = time_call(assemble, c3d)
    # XLA's own traffic estimate and kernel count against the least
    # traffic the assembly needs: coordinates in, 15 bands out
    xla_bytes = assemble.cost_analysis().get("bytes accessed")
    min_bytes = p.coords.nbytes + 15 * box.n_nodes * 4
    n_fusions = assemble.as_text().count("fusion(")
    log(f"[box] DIA assembly compile {compile_s:.2f} s, first "
        f"{first:.3f} s, steady {best * 1e3:.3f} ms "
        f"({box.n_nodes / best / 1e6:.1f} MDoF/s); {n_fusions} fusions, "
        f"XLA bytes accessed {xla_bytes / 1e9:.3f} GB vs minimum "
        f"{min_bytes / 1e9:.3f} GB ({xla_bytes / min_bytes:.1f}x); "
        f"minimum at 3.35 TB/s {min_bytes / 3.35e12 * 1e3:.3f} ms")
    bands = np.asarray(bands)
    assert bands.dtype == np.float32 and np.isfinite(bands).all()

    t0 = time.perf_counter()
    ref = reference_structured_bands(box, p.coords)
    scale = np.abs(ref).max(axis=0)
    asm_err = float((np.abs(bands - ref).max(axis=0)
                     / np.where(scale > 0, scale, 1.0)).max())
    log(f"[box] assembly vs float64 numpy stencil: row-scaled max error "
        f"{asm_err:.3e} (tol {ASM_TOL:g}; reference {time.perf_counter() - t0:.1f} s)")
    assert asm_err <= ASM_TOL, "DIA assembly disagrees with the f64 reference"
    del ref

    x = np.random.default_rng(0).random(box.n_nodes).astype(np.float32)
    A_csr = dia_csr(bands, box.offsets)
    y = np.asarray(jit_spmv()(DiaMatrix(jnp.asarray(bands), box.offsets),
                              jnp.asarray(x)))
    sp_err = spmv_error(y, A_csr, x)
    log(f"[box] DIA SpMV f32 vs scipy CSR f64: {sp_err:.3e} "
        f"(tol {SPMV_TOL[np.float32]:g})")
    assert sp_err <= SPMV_TOL[np.float32], "DIA SpMV disagrees with scipy"

    solve = structured_solver(p, rtol)
    (xs, iters, res), first, best = time_call(solve, c3d)
    iters = int(iters)
    assert xs.dtype == jnp.float32, f"f32 solve returned {xs.dtype}"
    # the system the device solved (f32 source and penalty), in f64
    pen32 = float(np.float32(PENALTY))
    rhs = np.asarray(jax.jit(lambda c: box.source_rhs(c, 1.0))(c3d),
                     np.float64)
    rhs = np.where(p.mask, pen32 * p.g, rhs)
    diag = A_csr.diagonal()
    diag[p.mask] = pen32
    A_csr.setdiag(diag)
    x0 = np.where(p.mask, p.g, 0.0)
    full, free = residuals(A_csr, rhs, np.asarray(xs), x0, p.mask)
    log(f"[box] MG-PCG: {iters} iterations, compile+first {first:.2f} s, "
        f"end-to-end step {best:.4f} s (assembly + MG setup + PCG), "
        f"monitored residual {float(res):.3e}")
    log(f"[box] true residual (host f64): ||b-Ax||/||b|| {full:.3e}, "
        f"free rows {free:.3e} (tol {SOLVE_TOL[np.float32]:g})")
    assert float(res) <= rtol * 1.5, "monitored residual above rtol"
    assert free <= SOLVE_TOL[np.float32], "MG-PCG true residual too large"


def phase_testlab(box_n: int = 100) -> None:
    from arcanefem_tpu import testlab

    t0 = time.perf_counter()
    testlab.main(["--box", str(box_n), "--cross-validate"])
    log(f"[testlab] box {box_n}: every format agrees "
        f"(f32, tol {testlab.CROSS_RTOL[np.float32]:g}; "
        f"{time.perf_counter() - t0:.1f} s)")


def phase_four_unstructured(h: float = 5.0, refine: int = 2,
                            n_dev: int = 4, rtol: float = 1e-10) -> None:
    """Sharded AMG-PCG (RCB partition) vs the one-card solve, fp64."""
    import jax.numpy as jnp

    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.ops import elements
    from arcanefem_tpu.parallel.partition import build_sharded
    from arcanefem_tpu.parallel.sharded import (
        device_mesh, put_sharded, stacked_node_mask,
    )
    from arcanefem_tpu.parallel.sharded_amg import (
        build_sharded_amg, make_poisson_amg_step, put_sharded_amg,
    )
    from arcanefem_tpu.problems import (
        AMG_OPTIONS, PENALTY, sphere_cut_mesh, sphere_cut_system,
    )
    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.solver.iterative import pcg
    from arcanefem_tpu.utils.timing import time_call

    mesh, topo, setup = sphere_cut_mesh(h, refine)
    log(f"[four-unstr] {mesh.n_nodes:,} DoF over {n_dev} devices; setup "
        + ", ".join(f"{k} {v:.1f}s" for k, v in setup.items()))
    system = sphere_cut_system(mesh)

    # one-card reference on device 0: generic assembly, fp64
    prob = FemProblem(mesh, ndof=1, dtype=np.float64)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    flat = np.asarray(A.values).reshape(-1).copy()
    flat[np.asarray(A.topo.diag_slot)[system.mask]] = PENALTY
    A = A.with_values(jnp.asarray(flat))
    t0 = time.perf_counter()
    amg = build_amg(A, values_np=flat, **AMG_OPTIONS)
    log(f"[four-unstr] AMG setup {time.perf_counter() - t0:.1f} s")
    (x1, it1, res1), first1, best1 = time_call(
        lambda: pcg(A, jnp.asarray(system.rhs), amg,
                    jnp.asarray(system.x0), rtol, 0.0, 1000))

    t0 = time.perf_counter()
    sp = build_sharded(mesh, n_dev)
    dmesh = device_mesh(n_dev)
    arrs = put_sharded(sp, dmesh, dtype=jnp.float64)
    samg = build_sharded_amg(sp, amg)
    samg_arrs = put_sharded_amg(samg, dmesh, np.float64)
    nodes = np.flatnonzero(system.mask)
    mask, val = stacked_node_mask(sp, nodes, system.x0[nodes])
    step = make_poisson_amg_step(sp, dmesh, samg, rtol=rtol, max_iter=1000)
    log(f"[four-unstr] partition + sharded setup "
        f"{time.perf_counter() - t0:.1f} s")
    (x4, it4, res4), first4, best4 = time_call(
        step, arrs, samg_arrs, samg.inner, 1.0, mask, val, PENALTY)
    g4 = sp.scatter_global(np.asarray(x4))
    x1 = np.asarray(x1)
    err = float(np.abs(g4 - x1).max() / np.abs(x1).max())
    log(f"[four-unstr] one card: {int(it1)} iterations, compile+first "
        f"{first1:.2f} s, solve {best1:.4f} s, monitored residual "
        f"{float(res1):.3e}; {n_dev} cards: {int(it4)} iterations, "
        f"compile+first {first4:.2f} s, solve {best4:.4f} s, monitored "
        f"residual {float(res4):.3e} (rtol {rtol:g})")
    log(f"[four-unstr] max|x_sharded - x_one| / max|x_one| = {err:.3e} "
        f"(tol {SHARDED_TOL:g})")
    assert float(res1) <= rtol * 1.5, "one-card AMG-PCG above rtol"
    assert float(res4) <= rtol * 1.5, "sharded AMG-PCG above rtol"
    assert err <= SHARDED_TOL, "sharded AMG-PCG disagrees with one card"


def phase_four_structured(n: int = 224, n_dev: int = 4,
                          rtol: float = 1e-10) -> None:
    """x-slab sharded MG-PCG vs the one-card MG-PCG, fp64."""
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.parallel.structured_mg import (
        make_structured_mg_step, mg_slab_coords, mg_slab_masks,
        plan_mg_slabs,
    )
    from arcanefem_tpu.parallel.structured_sharded import (
        gather_global, slab_mask_values,
    )
    from arcanefem_tpu.problems import (
        StructuredProblem, structured_problem, structured_solver,
    )
    from arcanefem_tpu.utils.timing import time_call

    p = structured_problem(n)
    p = StructuredProblem(box=p.box, coords=p.coords.astype(np.float64),
                          mask=p.mask, g=p.g.astype(np.float64))
    box = p.box
    solve = structured_solver(p, rtol)
    (x1, it1, res1), first1, best1 = time_call(solve, jnp.asarray(p.coords))

    plan = plan_mg_slabs(box, n_dev)
    smesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("xslabs",))
    shard = jax.sharding.NamedSharding(smesh,
                                       jax.sharding.PartitionSpec("xslabs"))
    cs = tuple(jax.device_put(jnp.asarray(c), shard)
               for c in mg_slab_coords(plan, p.coords))
    ms = tuple(jax.device_put(jnp.asarray(m), shard)
               for m in mg_slab_masks(plan))
    _, vs = slab_mask_values(plan.fine, p.mask, p.g)
    step = make_structured_mg_step(plan, smesh, rtol=rtol, max_iter=1000)
    (x4, it4, res4), first4, best4 = time_call(
        step, cs, ms, jax.device_put(jnp.asarray(vs), shard), 1.0)
    g4 = gather_global(plan.fine, np.asarray(x4))
    x1 = np.asarray(x1)
    err = float(np.abs(g4 - x1).max() / np.abs(x1).max())
    log(f"[four-box] {n}^3 over {n_dev} slabs, {len(plan.levels)} levels; "
        f"one card: {int(it1)} iterations, compile+first {first1:.2f} s, "
        f"step {best1:.4f} s, monitored residual {float(res1):.3e}; "
        f"{n_dev} cards: {int(it4)} iterations, compile+first "
        f"{first4:.2f} s, step {best4:.4f} s, monitored residual "
        f"{float(res4):.3e} (rtol {rtol:g})")
    log(f"[four-box] max|x_sharded - x_one| / max|x_one| = {err:.3e} "
        f"(tol {SHARDED_TOL:g})")
    assert float(res1) <= rtol * 1.5, "one-card MG-PCG above rtol"
    assert float(res4) <= rtol * 1.5, "sharded MG-PCG above rtol"
    assert err <= SHARDED_TOL, "sharded MG-PCG disagrees with one card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {jax.devices()}); refusing "
              "to run", file=sys.stderr)
        return 2

    from arcanefem_tpu.utils import device

    device.setup(x64=True)  # f32 phases pass explicit dtypes
    t_start = time.perf_counter()
    dev = phase_card()
    log_peak("card")
    if args.four:
        if dev["count"] < 4:
            print(f"chip_smoke --four: {dev['count']} GPU(s), need 4",
                  file=sys.stderr)
            return 2
        phase_four_unstructured()
        log_peak("four-unstr")
        phase_four_structured()
        log_peak("four-box")
    else:
        state = phase_unstructured()
        log_peak("unstr")
        phase_fp64(state)
        log_peak("fp64")
        del state
        phase_structured()
        log_peak("box")
        phase_testlab()
        log_peak("testlab")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
