"""Per-component timing of the structured MG-PCG iteration on the GPU.

Times each piece of one preconditioned-CG iteration of bench.py's
secondary (224³ box, 11.4M DoF, f32): DIA SpMV, damped-Jacobi sweep,
restrict + prolong hop, full V-cycle apply and compensated dot.  One CG
iteration = SpMV + V-cycle + 2 dots + 3 axpys; compare with bench.py's
step time over its iteration count.

Each probe is one jit that assembles the system and MG hierarchy, then
runs ``k`` repeats of the component in a ``lax.fori_loop`` and returns a
scalar; k is a dynamic bound, so (t(k2) - t(k1)) / (k2 - k1) cancels the
setup.  Times are best-of-3 ``block_until_ready`` calls.

    python tools/profile_iter.py     # BENCH_N resizes (default 224)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from arcanefem_tpu.utils import device

    device.setup(cpu=os.environ.get("BENCH_CPU") == "1")
    import jax
    import jax.numpy as jnp

    from arcanefem_tpu.mesh.structured import apply_penalty_dirichlet
    from arcanefem_tpu.problems import PENALTY, structured_problem
    from arcanefem_tpu.solver.iterative import precise_dot
    from arcanefem_tpu.solver.multigrid import build_mg, prolong3, restrict3
    from arcanefem_tpu.utils.timing import time_call

    n = int(os.environ.get("BENCH_N", "224"))
    p = structured_problem(n)
    box = p.box
    print(f"{device.describe()} grid={n}^3 nodes={box.n_nodes:,}",
          flush=True)
    c3d = jnp.asarray(p.coords)
    mask, g = jnp.asarray(p.mask), jnp.asarray(p.g)

    def setup(c3d):
        A = box.assemble_stiffness(c3d)
        rhs = box.source_rhs(c3d, 1.0)
        A, rhs = apply_penalty_dirichlet(A, rhs, mask, g, PENALTY)
        return A, rhs, build_mg(box, c3d, p.mask, PENALTY, nu=1)

    def slope_ms(op, k1=2, k2=10):
        @jax.jit
        def run(c3d, k):
            A, b, M = setup(c3d)
            v0 = jnp.where(mask, g, 0.0) + 1e-3
            return jnp.sum(jax.lax.fori_loop(
                0, k, lambda i, v: op(A, M, b, v), v0))

        t1 = time_call(run, c3d, k1)[2]
        t2 = time_call(run, c3d, k2)[2]
        return max(t2 - t1, 0.0) / (k2 - k1) * 1e3

    def hop(A, M, b, v):
        rc = restrict3(v, M.shapes[0], M.shapes[1])
        return v + 1e-9 * prolong3(rc, M.shapes[1], M.shapes[0])

    ops = [
        ("spmv A@x", lambda A, M, b, v: A.spmv(v)),
        ("jacobi sweep", lambda A, M, b, v:
            v + 0.8 * M.inv_diags[0] * (b - A.spmv(v))),
        ("V-cycle apply", lambda A, M, b, v: M.apply(v)),
        ("precise_dot+axpy", lambda A, M, b, v:
            v + precise_dot(v, b) * 1e-9 * b),
    ]
    if n % 2 == 0 and n // 2 >= 8:  # build_mg coarsens at least once
        ops.insert(2, ("restrict+prolong hop", hop))
    for name, op in ops:
        print(f"{name:22s} {slope_ms(op):8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
