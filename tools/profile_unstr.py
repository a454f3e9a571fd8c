"""Per-component timing of the unstructured AMG-PCG iteration on the GPU.

Decomposes bench.py's unstructured primary (sphere_cut, 1.9M DoF by
default) into its per-iteration pieces: fine-level SpMV, per-level SpMVs,
the level-0 transfer pair, the Chebyshev fine smoother, one full V-cycle
and the compensated dot.  A Chebyshev(2) V(1,1) PCG iteration spends
5 fine SpMVs (1 Krylov A·p + 4 in the V-cycle), so ~5x the fine SpMV plus
transfers, coarse levels and dots should reconcile with bench.py's
ms/iter; the gap is dispatch and layout overhead.

Each probe is one jit running ``k`` repeats of the component in a
``lax.fori_loop`` (operators passed as arguments); the time per repeat is
the best of a few ``block_until_ready`` calls divided by k.

    python tools/profile_unstr.py            # BENCH_UNSTR_H / _REFINE
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe(name, fn, ops, v, k=16):
    """ms per application of fn(ops, x) -> x-shaped vector."""
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.utils.timing import time_call

    @jax.jit
    def run(ops, v):
        def body(_, x):
            y = fn(ops, x)
            return y / (jnp.linalg.norm(y) + 1e-30)  # keep f32 in range
        return jax.lax.fori_loop(0, k, body, v)

    _, _, best = time_call(run, ops, v)
    ms = best / k * 1e3
    print(f"[prof] {name:<30s} {ms:8.3f} ms", flush=True)
    return ms


def main():
    from arcanefem_tpu.utils import device

    device.setup(cpu=os.environ.get("BENCH_CPU") == "1")
    import jax.numpy as jnp

    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.problems import (
        AMG_OPTIONS, bell_matrix, penalized_values, sphere_cut_system,
    )
    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.solver.iterative import precise_dot
    from arcanefem_tpu.utils.cache import sphere_cut_cached

    h = float(os.environ.get("BENCH_UNSTR_H", "5"))
    refine = int(os.environ.get("BENCH_UNSTR_REFINE", "2"))
    mesh, topo = sphere_cut_cached(h, refine)
    n = topo.n_nodes
    print(f"[prof] {device.describe()} {n:,} nodes, W={topo.width}, "
          f"nnz={topo.nnz:,}", flush=True)
    vals = np.asarray(TetraLaneAssembler(topo, mesh.cells["tetra4"])(
        jnp.asarray(mesh.coords.astype(np.float32))))
    flat = penalized_values(vals, topo, sphere_cut_system(mesh).mask)
    A = bell_matrix(flat, topo, np.float32)
    M = build_amg(A, values_np=flat, **AMG_OPTIONS)
    print(f"[prof] AMG levels={[m.topo.n_nodes for m in M.mats]}",
          flush=True)

    def rand(m, seed):
        return jnp.asarray(np.random.default_rng(seed).random(m)
                           .astype(np.float32))

    x = rand(n, 0)
    r = {"fine_spmv": probe("fine SpMV (A·p)", lambda o, v: o.spmv(v), A, x)}
    for lvl in range(1, len(M.mats)):
        nl = M.mats[lvl].topo.n_nodes
        r[f"spmv_l{lvl}"] = probe(f"level-{lvl} SpMV (n={nl:,})",
                                  lambda o, v: o.spmv(v), M.mats[lvl],
                                  rand(nl, lvl))
    r["transfer_pair_l0"] = probe(
        "transfer down+up (level 0)",
        lambda o, v: o._transfer_up(0, o._transfer_down(0, v)), M, x)
    r["cheb_smooth_l0"] = probe("cheb fine smoother",
                                lambda o, v: o._smooth_cheb(0, v), M, x)
    r["vcycle"] = probe("full V-cycle apply", lambda o, v: o.apply(v), M, x,
                        k=4)
    r["precise_dot"] = probe(
        "compensated dot", lambda o, v: v * precise_dot(v, v), A, x)
    model = 5 * r["fine_spmv"] + r["transfer_pair_l0"] + sum(
        v for k_, v in r.items() if k_.startswith("spmv_l"))
    print(f"[prof] model ms/iter ≈ 5·fine + transfers + coarse = "
          f"{model:.2f} ms (excludes dots/axpys)", flush=True)


if __name__ == "__main__":
    main()
