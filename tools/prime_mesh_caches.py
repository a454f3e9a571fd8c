"""Prime the tools' sphere_cut mesh cache (utils/cache.py) for one size.

Builds the mesh, node order and topology of problems.sphere_cut_mesh on
the host and stores them, so conv_tune.py, profile_unstr.py and
profile_amg_setup.py start from the cached system.  bench.py and
chip_smoke.py do not read this cache.

Usage: python tools/prime_mesh_caches.py [h] [refine]   (default 6 3)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from arcanefem_tpu.utils.cache import sphere_cut_cached

    h = float(sys.argv[1]) if len(sys.argv) > 1 else 6.0
    refine = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    t0 = time.time()
    mesh, topo = sphere_cut_cached(h, refine)
    print(f"sphere_cut h={h:g} refine={refine}: {mesh.n_nodes:,} nodes, "
          f"W={topo.width}, nnz={topo.nnz:,} ({time.time() - t0:.0f}s)",
          flush=True)


if __name__ == "__main__":
    main()
