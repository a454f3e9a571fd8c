"""Setup-artifact cache for the host-side tools (tools/).

The tuning and profiling tools rebuild the same sphere_cut system many
times; its mesh, node order and topology are pure functions of
(h, refine, seed), so they keep them as npz files here.  ``bench.py`` and
``chip_smoke.py`` never read this cache: they build cold from the seed,
which is what a fresh checkout pays.  AFEM_CACHE_DIR overrides the
location (default ``<repo>/.cache/afem_meshes``, gitignored).
"""

from __future__ import annotations

import os

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE_DIR = os.environ.get(
    "AFEM_CACHE_DIR", os.path.join(_REPO_ROOT, ".cache", "afem_meshes"))


def cache_dir() -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return CACHE_DIR


def cache_path(name: str) -> str:
    return os.path.join(cache_dir(), name)


_TOPO_FIELDS = ("ell_cols", "ell_valid", "row_ptr", "csr_cols",
                "csr_to_ell", "diag_slot")


def sphere_cut_cached(h: float, refine: int, seed: int = 0):
    """(mesh, topology) of problems.sphere_cut_mesh, through an npz cache."""
    from ..mesh.core import Mesh
    from ..problems import sphere_cut_mesh
    from ..sparse.topology import Topology

    path = cache_path(f"sphere_cut_h{h:g}_r{refine}_s{seed}.npz")
    if os.path.exists(path):
        z = np.load(path)
        mesh = Mesh(
            coords=z["coords"], node_uids=z["uids"],
            cells={"tetra4": z["tets"]}, dim=3,
            face_groups={"Cut": {"tria3": z["cut"]},
                         "sphere": {"tria3": z["sphere"]}},
        )
        topo = Topology(n_nodes=int(z["n_nodes"]), width=int(z["width"]),
                        slot_maps={"tetra4": z["slot_tetra4"]},
                        **{k: z[k] for k in _TOPO_FIELDS})
        return mesh, topo
    mesh, topo, _ = sphere_cut_mesh(h, refine, seed)
    np.savez(
        path, coords=mesh.coords, uids=mesh.node_uids,
        tets=mesh.cells["tetra4"], cut=mesh.face_groups["Cut"]["tria3"],
        sphere=mesh.face_groups["sphere"]["tria3"], n_nodes=topo.n_nodes,
        width=topo.width, slot_tetra4=topo.slot_maps["tetra4"],
        **{k: getattr(topo, k) for k in _TOPO_FIELDS},
    )
    return mesh, topo
