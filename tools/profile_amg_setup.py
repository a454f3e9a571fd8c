"""Phase-profile the host-side AMG setup of the benchmark system (CPU).

Builds (or loads from the tools' mesh cache, utils/cache.py) the
sphere_cut system of problems.py, assembles it, applies the penalty BCs
and runs build_amg under AFEM_AMG_VERBOSE=1, so the scipy/native pipeline
(strength → aggregation → smoothed P → Galerkin → rho) is timed per
level.  The reference's HypreSetup takes 0.5-1.5 s at 10M rows
(HypreDoFLinearSystem.cc:730).

Usage: python tools/profile_amg_setup.py [h] [refine]   (default 5 2)
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["AFEM_AMG_VERBOSE"] = "1"


def main():
    from arcanefem_tpu.utils import device

    device.setup(cpu=True)
    import jax.numpy as jnp

    from arcanefem_tpu.ops.lane_assembly import TetraLaneAssembler
    from arcanefem_tpu.problems import (
        AMG_OPTIONS, bell_matrix, penalized_values, sphere_cut_system,
    )
    from arcanefem_tpu.solver.amg import build_amg
    from arcanefem_tpu.utils.cache import sphere_cut_cached

    h = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    refine = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    t0 = time.time()
    mesh, topo = sphere_cut_cached(h, refine)
    print(f"mesh {time.time()-t0:.1f}s  n={topo.n_nodes:,}", flush=True)

    t0 = time.time()
    vals = np.asarray(TetraLaneAssembler(topo, mesh.cells["tetra4"])(
        jnp.asarray(mesh.coords.astype(np.float32))))
    flat = penalized_values(vals, topo, sphere_cut_system(mesh).mask)
    A = bell_matrix(flat, topo, np.float32)
    print(f"assembly + BCs {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    M = build_amg(A, values_np=flat, **AMG_OPTIONS)
    print(f"build_amg TOTAL {time.time()-t0:.1f}s  "
          f"levels={[m.topo.n_nodes for m in M.mats]}", flush=True)


if __name__ == "__main__":
    main()
