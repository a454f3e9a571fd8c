"""North-star benchmark: Poisson 3D — assembly + PCG to 1e-8, on the GPU.

Two problems, mirroring the reference's benchmark methodology
(modules/testlab/benchmarking/run-benchmark.sh: cache-warmed assembly
timing + per-phase solve timers; BASELINE.md's sphere_cut recipe), run in
turn in ONE process (arcanefem_tpu/problems.py builds both cold from a
seed):

1. PRIMARY — unstructured ``sphere_cut`` tetra mesh, 1.9M DoF by default
   (BENCH_UNSTR_H=5 BENCH_UNSTR_REFINE=2; 6/3 gives 8.9M): segment-sum
   assembly + SA-AMG-preconditioned CG (solver/amg.py, the BoomerAMG role).
   Host setup (mesh, ordering, topology, AMG setup — the analogue of the
   reference's HypreSetup timer) is reported apart from the metric.
2. SECONDARY — structured Kuhn-tet box at 224³ (11.4M DoF, BENCH_N):
   DIA slice-add assembly + geometric-MG PCG, one jitted step.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
value = end-to-end seconds (assembly + solve) of the PRIMARY metric;
smaller is better.  extra names the platform, device kind and device
count, and carries the secondary metric and the phase breakdown.  The
reference publishes no absolute numbers, so vs_baseline is the A100
ROOFLINE ESTIMATE of the reference's own pipeline on this exact system
(reference_roofline_estimate; derivation in BASELINE.md), reported as
estimate/measured — >1 means faster than the estimate.  Phase breakdown
goes to stderr.

The run needs a GPU and exits non-zero without one; BENCH_CPU=1 asks for
the CPU explicitly (set small BENCH_UNSTR_H/BENCH_N there).  Any failed
phase fails the run.  BENCH_UNSTR=0 or BENCH_BOX=0 skips a problem;
BENCH_RTOL sets the tolerance.  ``--sweep`` runs the assembly-strategy x
size x device-count table (bench_sweep).
"""

from __future__ import annotations

import gc
import json
import os
import sys

import numpy as np

from arcanefem_tpu.utils import device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reference_roofline_estimate(n_dofs: int, nnz: int) -> float:
    """Estimated seconds for the reference's A100 pipeline on this system.

    Bandwidth-roofline model of CUDA BSR atomic assembly
    (reference femutils/BSRFormat.h:842-898) + fp64 Hypre BoomerAMG-PCG
    (HypreDoFLinearSystem.cc:686-742) to rtol 1e-8, with every constant at
    the A100-favourable end; derivation + sources in BASELINE.md
    ("Reference-path roofline estimate").  AMG setup excluded on both
    sides (separate HypreSetup phase).
    """
    ref_assembly_s = n_dofs / 400e6          # 400 MDoF/s atomic assembly
    spmv_bytes = 12 * nnz + 16 * n_dofs      # fp64 CSR + x gather + y write
    ref_iter_s = 7 * spmv_bytes / 1.4e12     # 7 SpMV-equivalents @1.4TB/s
    return ref_assembly_s + 14 * ref_iter_s  # 14 PCG iterations


def _setup():
    device.setup(cpu=os.environ.get("BENCH_CPU") == "1")
    return device.describe()


def _rtol() -> float:
    return float(os.environ.get("BENCH_RTOL", "1e-8"))


def bench_structured() -> dict:
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.problems import structured_problem, structured_solver
    from arcanefem_tpu.utils.timing import time_call

    n = int(os.environ.get("BENCH_N", "224"))
    rtol = _rtol()
    p = structured_problem(n)
    box = p.box
    log(f"[box] grid={n}^3 nodes={box.n_nodes:,} cells={box.n_cells:,}")
    c3d = jnp.asarray(p.coords)

    asm = jax.jit(lambda c: box.assemble_stiffness(c).bands)
    _, asm_first, asm_s = time_call(asm, c3d)
    asm_mdofs = box.n_nodes / asm_s / 1e6
    log(f"[box] assembly compile+first {asm_first:.2f}s, "
        f"{asm_s*1e3:.2f} ms -> {asm_mdofs:.0f} MDoF/s")

    solve = structured_solver(p, rtol)
    (x, iters, res), first, total = time_call(solve, c3d)
    iters = int(iters)
    log(f"[box] solve compile+first {first:.1f}s; end-to-end {total:.4f} s "
        f"({iters} iters, rel res {float(res):.2e})")
    assert float(res) <= rtol * 1.5, "MG-PCG did not converge to target"
    assert np.isfinite(float(jnp.sum(x))), "non-finite solution"
    return {
        "metric": (f"poisson3d_box_{box.n_nodes/1e6:.3g}MDoF"
                   f"_assembly+mgpcg_to_{rtol:g}_s"),
        "value": total,
        "assembly_s": asm_s,
        "assembly_mdofs": asm_mdofs,
        "compile_first_s": first,
        "iterations": iters,
        "n_dofs": box.n_nodes,
        # 15-offset Kuhn stencil = the stored operator (structured.py)
        "nnz_stored": 15 * box.n_nodes,
    }


def bench_unstructured() -> dict:
    """PRIMARY: sphere_cut tetra mesh, BELL assembly + AMG-PCG to rtol."""
    import time

    import jax.numpy as jnp

    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.problems import (
        AMG_OPTIONS, bell_matrix, penalized_values, sphere_cut_mesh,
        sphere_cut_system,
    )
    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.solver.iterative import pcg
    from arcanefem_tpu.utils.timing import time_call

    h = float(os.environ.get("BENCH_UNSTR_H", "5"))
    refine = int(os.environ.get("BENCH_UNSTR_REFINE", "2"))
    rtol = _rtol()

    mesh, topo, setup = sphere_cut_mesh(h, refine)
    n = topo.n_nodes
    log(f"[unstr] {n:,} nodes / {mesh.n_cells:,} tets, W={topo.width}, "
        f"nnz={topo.nnz:,}; setup " + ", ".join(
            f"{k} {v:.1f}s" for k, v in setup.items()))

    asm = TetraLaneAssembler(topo, mesh.cells["tetra4"])
    coords = jnp.asarray(mesh.coords.astype(np.float32))
    vals, asm_first, asm_s = time_call(asm, coords)
    asm_mdofs = n / asm_s / 1e6
    log(f"[unstr] assembly compile+first {asm_first:.2f}s, "
        f"{asm_s*1e3:.2f} ms -> {asm_mdofs:.1f} MDoF/s")

    system = sphere_cut_system(mesh)
    t0 = time.perf_counter()
    flat = penalized_values(np.asarray(vals), topo, system.mask)
    del asm, vals
    A = bell_matrix(flat, topo, np.float32)
    M = build_amg(A, values_np=flat, **AMG_OPTIONS)
    setup["amg_setup_s"] = time.perf_counter() - t0
    log(f"[unstr] AMG setup {setup['amg_setup_s']:.1f}s, "
        f"levels={[m.topo.n_nodes for m in M.mats]}")

    b = jnp.asarray(system.rhs.astype(np.float32))
    x0 = jnp.asarray(system.x0.astype(np.float32))
    (x, iters, res), first, solve_s = time_call(
        lambda: pcg(A, b, M, x0, rtol, 0.0, 1000, use_precise_dot=True))
    iters = int(iters)
    log(f"[unstr] solve compile+first {first:.1f}s; {solve_s:.4f}s "
        f"({iters} iters to {float(res):.1e}, "
        f"{solve_s/max(iters,1)*1e3:.2f} ms/iter)")
    assert float(res) <= rtol * 1.5, "AMG-PCG did not converge"
    assert np.isfinite(float(jnp.sum(x))), "non-finite solution"
    return {
        "metric": (f"poisson3d_sphere_cut_{n/1e6:.1f}MDoF"
                   f"_assembly+amgpcg_to_{rtol:g}_s"),
        "value": asm_s + solve_s,
        "assembly_s": asm_s,
        "solve_s": solve_s,
        "ms_per_iter": solve_s / max(iters, 1) * 1e3,
        "assembly_mdofs": asm_mdofs,
        "compile_first_s": asm_first + first,
        **setup,
        "iterations": iters,
        "n_dofs": int(n),
        "nnz_stored": int(topo.nnz),
    }


def final_json(primary: dict | None, secondary: dict | None,
               dev: dict) -> dict:
    """The single output line from the problems that ran."""
    if primary is None:
        primary, secondary = secondary, None
    extra = {k: v for k, v in primary.items() if k not in ("metric", "value")}
    extra.update(dev)
    if secondary is not None:
        extra["secondary_metric"] = secondary["metric"]
        extra["secondary_value"] = secondary["value"]
        extra["secondary_assembly_mdofs"] = secondary["assembly_mdofs"]
        extra["secondary_iterations"] = secondary["iterations"]
    # vs_baseline: the A100 roofline estimate of the reference's own GPU
    # pipeline on this exact system (BASELINE.md); only a GPU run is
    # compared with it
    ref_s = reference_roofline_estimate(primary["n_dofs"],
                                        primary["nnz_stored"])
    extra["baseline_kind"] = "a100-roofline-estimate"
    extra["baseline_estimate_s"] = ref_s
    vs = ref_s / primary["value"] if dev["platform"] == "gpu" else None
    return {"metric": primary["metric"], "value": primary["value"],
            "unit": "s", "vs_baseline": vs, "extra": extra}


def _sweep_child_devices(n_devices: int, box_n: int, reps: int) -> None:
    """Child process: sharded Poisson solve on n virtual CPU devices.

    The device-count axis of the reference's sweep (run-benchmark.sh:13-45,
    MPI_N=(1 2 4 8)); correctness = partition invariance vs the model
    solve, wall time per solve step is reported for the sweep table
    (virtual CPU devices — structure, not absolute-perf, parity).
    """
    import time

    import jax

    device.setup(cpu=True, x64=True)
    import jax.numpy as jnp

    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu.mesh.generate import box_tetra_mesh
    from arcanefem_tpu.models.poisson import PoissonConfig
    from arcanefem_tpu.models.poisson import solve as poisson_solve
    from arcanefem_tpu.parallel.partition import build_sharded
    from arcanefem_tpu.parallel.sharded import (
        device_mesh, make_poisson_step, put_sharded, stacked_node_mask,
    )

    assert jax.device_count() >= n_devices, (
        f"need {n_devices} devices, have {jax.device_count()}"
    )
    mesh = box_tetra_mesh(box_n, box_n, box_n)
    sp = build_sharded(mesh, n_devices)
    dmesh = device_mesh(n_devices)
    arrs = put_sharded(sp, dmesh, dtype=jnp.float64)
    xmin, xmax = mesh.group_nodes("xmin"), mesh.group_nodes("xmax")
    nodes = np.concatenate([xmin, xmax])
    vals = np.concatenate([np.zeros(len(xmin)), np.ones(len(xmax))])
    mask, val = stacked_node_mask(sp, nodes, vals)
    step = make_poisson_step(sp, dmesh, rtol=1e-10, max_iter=2000)

    x, iters, res = step(arrs, 1.0, mask, val, 1.0e12)
    got = sp.scatter_global(np.asarray(x))
    ref = np.asarray(
        poisson_solve(
            mesh,
            PoissonConfig(
                f=1.0,
                bcs=BoundaryConditions(dirichlet=[
                    DirichletBC(surface="xmin", value=0.0),
                    DirichletBC(surface="xmax", value=1.0),
                ]),
            ),
            dtype=np.float64,
        ).u
    )
    err = float(np.max(np.abs(got - ref) / (np.abs(ref).max() or 1.0)))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x, iters, res = jax.block_until_ready(
            step(arrs, 1.0, mask, val, 1.0e12))
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "devices": n_devices, "nodes": mesh.n_nodes,
        "solve_s": min(times), "iterations": int(iters),
        "residual": float(res), "partition_rel_err": err,
        # two independent PCG runs to rtol=1e-10 agree to ~the dryrun's
        # f64 comparison tolerance, not to the rtol itself
        "invariant": err < 1e-6,
    }))


def bench_sweep(argv: list[str]) -> None:
    """`bench.py --sweep`: sizes x strategies x device counts.

    Mirrors modules/testlab/benchmarking/run-benchmark.sh:13-45 (sizes
    small/medium/large, CACHE_WARMING=5, MPI_N=(1 2 4 8)) and its
    results.tsv/time_stats.json outputs.  Emits one JSON line per row to
    stdout and a TSV table (--tsv, default bench_sweep.tsv).
    """
    import argparse
    import subprocess

    p = argparse.ArgumentParser(prog="bench.py --sweep")
    p.add_argument("--sizes", default="32,64,96",
                   help="comma list of box n")
    p.add_argument("--formats", default=None,
                   help="comma list of assembly strategies (default: all)")
    p.add_argument("--devices", default="1,2,4,8",
                   help="virtual device counts for the sharded axis")
    p.add_argument("--cache-warming", type=int, default=5)
    p.add_argument("--tsv", default="bench_sweep.tsv")
    p.add_argument("--no-devices", action="store_true",
                   help="skip the device-count axis")
    args = p.parse_args(argv)

    dev = _setup()

    from arcanefem_tpu import testlab
    from arcanefem_tpu.mesh.generate import box_tetra_mesh

    formats = args.formats.split(",") if args.formats else None
    rows = []

    # Axis 1: assembly strategies x sizes (cache-warmed, testlab.run_lab)
    for n in [int(s) for s in args.sizes.split(",")]:
        stats = testlab.run_lab(
            box_tetra_mesh(n, n, n), formats=formats,
            cache_warming=args.cache_warming, dtype=np.float32,
        )
        for fmt, fs in stats["formats"].items():
            row = {
                "axis": "assembly", "size": f"box{n}",
                "nodes": stats["nbNode"], "elements": stats["nbElement"],
                "format": fmt, "devices": 1, **dev,
                "lhs_matrix_assembly_s": fs["lhs-matrix-assembly"],
                "mdof_per_s": fs["mdof_per_s"],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    # Axis 2: device counts (subprocess with virtual CPU devices — the
    # mpirun -n {1,2,4,8} partition-invariance sweep)
    if not args.no_devices:
        for nd in [int(d) for d in args.devices.split(",")]:
            env = dict(os.environ)
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={nd}"
            )
            env["JAX_PLATFORMS"] = "cpu"
            box_n = 10
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--sweep-child-devices", str(nd), str(box_n),
                 str(max(2, args.cache_warming))],
                env=env, capture_output=True, text=True, timeout=1800,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"sweep devices={nd} failed:\n"
                    + "\n".join(proc.stderr.splitlines()[-10:]))
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            assert child["invariant"], (
                f"partition invariance FAILED at n={nd}: "
                f"rel err {child['partition_rel_err']:.2e}"
            )
            row = {
                "axis": "devices", "size": f"box{box_n}",
                "nodes": child["nodes"], "format": "sharded-rcb-pcg",
                "devices": nd, "platform": "cpu",
                "solve_s": child["solve_s"],
                "iterations": child["iterations"],
                "invariant": child["invariant"],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.tsv:
        keys = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        with open(args.tsv, "w") as f:
            f.write("\t".join(keys) + "\n")
            for r in rows:
                f.write("\t".join(str(r.get(k, "")) for k in keys) + "\n")
        log(f"[sweep] {len(rows)} rows -> {args.tsv}")


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--sweep-child-devices":
        _sweep_child_devices(
            int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
        )
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--sweep":
        bench_sweep(sys.argv[2:])
        return

    dev = _setup()
    log(f"[bench] {dev}")
    primary = secondary = None
    if os.environ.get("BENCH_UNSTR", "1") == "1":
        primary = bench_unstructured()
        # the primary's device arrays died with its frame; collect them
        # before the 11.4M box allocates
        gc.collect()
    if os.environ.get("BENCH_BOX", "1") == "1":
        secondary = bench_structured()
    if primary is None and secondary is None:
        raise SystemExit("nothing to run: BENCH_UNSTR=0 and BENCH_BOX=0")
    out = final_json(primary, secondary, dev)
    out["extra"]["device_peak_bytes"] = device.peak_bytes()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
