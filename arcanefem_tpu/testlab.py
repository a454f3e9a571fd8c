"""Assembly-strategy laboratory (the reference's `testlab` module).

The reference's testlab is a Poisson clone with 11 switchable bilinear-
assembly strategies (legacy DOK, COO±sort CPU/GPU, CSR, CSR-GPU, node-wise
CSR, build-less CSR, BSR±atomic-free; modules/testlab/FemModule.cc:166-254),
cache-warming timed runs, cross-validation of every format against the
legacy assembly, and a JSON time-stats dump (FemModule.cc:19-56).

Here every strategy below produces the same BELL/CSR values over the same
topology, differing in how the scatter is scheduled:

* ``bell-segsum``     — unsorted segment-sum into flat ELL slots (default;
                        the BSR-atomic analogue)
* ``bell-sorted``     — entries pre-sorted by slot at build time, summed
                        with ``indices_are_sorted=True`` (the COO-sort
                        analogue; deterministic reduction order)
* ``bell-scatter``    — ``.at[].add`` scatter-add (the GPU-atomic analogue;
                        XLA lowers to scatter)
* ``csr-segsum``      — assemble the CSR value array, then expand to BELL
                        (the CsrFormat + translateToLinearSystem analogue)
* ``dia-stencil``     — structured meshes only: static slice-add stencil
                        assembly (the build-less analogue: sparsity derived
                        from structure, no search)

Cross-validation mirrors testlab's CROSS_VALIDATION: every format must
agree with the dense reference assembly bit-for-bit up to reduction order.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from .fem.timer import PhaseTimer
from .mesh.core import Mesh, read_msh
from .mesh.generate import box_tetra_mesh, rect_tria_mesh
from .ops import elements
from .sparse.bell import BellMatrix, assemble_bell
from .sparse.topology import Topology, build_topology
from .utils.timing import time_call


# --------------------------------------------------------------------------
# assembly strategies
# --------------------------------------------------------------------------

def assemble_bell_segsum(topo: Topology, mats: dict, dtype) -> BellMatrix:
    return assemble_bell(topo, mats, block=1, dtype=dtype)


def assemble_bell_sorted(topo: Topology, mats: dict, dtype) -> BellMatrix:
    """Pre-sorted entries: the sort permutation is static (host, once)."""
    order, slots_sorted = _sorted_maps(topo)
    flat = jnp.concatenate([m.reshape(-1) for m in mats.values()])
    vals = jax.ops.segment_sum(
        flat[order], slots_sorted,
        num_segments=topo.n_slots, indices_are_sorted=True,
    )
    return BellMatrix(
        values=vals.reshape(topo.n_nodes, topo.width, 1, 1).astype(dtype),
        topo=topo, block=1,
    )


def assemble_bell_scatter(topo: Topology, mats: dict, dtype) -> BellMatrix:
    vals = jnp.zeros(topo.n_slots, dtype)
    for name, ke in mats.items():
        slots = jnp.asarray(topo.slot_maps[name].reshape(-1))
        vals = vals.at[slots].add(ke.reshape(-1).astype(dtype))
    return BellMatrix(
        values=vals.reshape(topo.n_nodes, topo.width, 1, 1), topo=topo, block=1
    )


def assemble_csr_segsum(topo: Topology, mats: dict, dtype) -> BellMatrix:
    """Assemble CSR values, then expand into the BELL layout (the
    CsrFormatMatrix::translateToLinearSystem role)."""
    ell_to_csr = _ell_to_csr(topo)
    acc = None
    for name, ke in mats.items():
        csr_slot = jnp.asarray(ell_to_csr[topo.slot_maps[name].reshape(-1)])
        part = jax.ops.segment_sum(
            ke.reshape(-1), csr_slot, num_segments=topo.nnz
        )
        acc = part if acc is None else acc + part
    flat = jnp.zeros(topo.n_slots, dtype)
    flat = flat.at[jnp.asarray(topo.csr_to_ell)].set(acc.astype(dtype))
    return BellMatrix(
        values=flat.reshape(topo.n_nodes, topo.width, 1, 1), topo=topo, block=1
    )


def _sorted_maps(topo: Topology):
    # cached on the topology object (id()-keyed dicts can alias after GC)
    if not hasattr(topo, "_testlab_sorted"):
        slots = np.concatenate(
            [topo.slot_maps[k].reshape(-1) for k in topo.slot_maps]
        )
        order = np.argsort(slots, kind="stable")
        topo._testlab_sorted = (jnp.asarray(order), jnp.asarray(slots[order]))
    return topo._testlab_sorted


def _ell_to_csr(topo: Topology) -> np.ndarray:
    if not hasattr(topo, "_testlab_ell2csr"):
        inv = np.zeros(topo.n_slots, np.int32)
        inv[topo.csr_to_ell] = np.arange(topo.nnz, dtype=np.int32)
        topo._testlab_ell2csr = inv
    return topo._testlab_ell2csr


def assemble_coo(topo: Topology, mats: dict, dtype, sort=False) -> BellMatrix:
    """Standalone COO triplets (duplicates kept), then translate — the
    CooBiliAssembly / CooSortBiliAssembly strategies (sort=True)."""
    from .sparse.coo import CooMatrix

    ell_cols_flat = np.asarray(topo.ell_cols).reshape(-1)
    rows_l, cols_l, vals_l = [], [], []
    for name, ke in mats.items():
        slots = np.asarray(topo.slot_maps[name]).reshape(-1)
        rows_l.append((slots // topo.width).astype(np.int32))
        cols_l.append(ell_cols_flat[slots].astype(np.int32))
        vals_l.append(ke.reshape(-1))
    coo = CooMatrix(
        rows=np.concatenate(rows_l),
        cols=np.concatenate(cols_l),
        vals=jnp.concatenate(vals_l).astype(dtype),
        n=topo.n_nodes,
    )
    if sort:
        coo = coo.sorted()
    return coo.to_bell(topo)


FORMATS = {
    "bell-segsum": assemble_bell_segsum,
    "bell-sorted": assemble_bell_sorted,
    "bell-scatter": assemble_bell_scatter,
    "csr-segsum": assemble_csr_segsum,
    "coo": assemble_coo,
    "coo-sorted": lambda topo, mats, dtype: assemble_coo(
        topo, mats, dtype, sort=True
    ),
}

# ``dia-stencil`` (the build-less-CSR analogue: sparsity derived from mesh
# structure, zero search/sort) only exists for generated structured boxes —
# it assembles a DiaMatrix via static slice-adds (mesh/structured.py) rather
# than BELL values over a Topology, so it is dispatched separately in
# run_lab/cross_validate and validated by SpMV equivalence instead of a
# value-array diff.
STRUCTURED_FORMATS = ("dia-stencil",)

# cross-validation tolerance (max abs difference over max abs value): the
# formats sum the same element entries in different orders (atomics on the
# GPU sum in run-dependent order), so they agree to rounding — ~24 terms
# per slot at unit roundoff 6e-8 in f32, 1.1e-16 in f64 — with margin
CROSS_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


# --------------------------------------------------------------------------
# the lab
# --------------------------------------------------------------------------

def element_matrices(mesh: Mesh, dtype) -> dict:
    coords = jnp.asarray(mesh.coords.astype(dtype))
    return {
        ct: elements.stiffness(ct, coords[jnp.asarray(conn)])
        for ct, conn in mesh.cells.items()
    }


def cross_validate(mesh: Mesh, dtype=np.float64, rtol=1e-12, box=None) -> dict:
    """Every strategy against the first one (testlab CROSS_VALIDATION).

    With a StructuredBox, additionally validates the dia-stencil assembly
    by SpMV equivalence (its DIA layout has no BELL value array to diff)."""
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    mats = element_matrices(mesh, dtype)
    ref = None
    refA = None
    report = {}
    for name, fn in FORMATS.items():
        A = fn(topo, mats, dtype)
        v = np.asarray(A.values).reshape(-1)
        if ref is None:
            ref, refA = v, A
            report[name] = 0.0
        else:
            scale = np.abs(ref).max()
            report[name] = float(np.abs(v - ref).max() / scale)
            assert report[name] < rtol, (name, report[name])
    if box is not None:
        c3d = jnp.asarray(mesh.coords.astype(dtype).reshape(
            box.nx + 1, box.ny + 1, box.nz + 1, 3))
        Ad = box.assemble_stiffness(c3d)
        x = jnp.asarray(
            np.random.RandomState(0).rand(mesh.n_nodes).astype(dtype))
        yd = np.asarray(Ad.spmv(x))
        yb = np.asarray(refA.spmv(x))
        err = float(np.abs(yd - yb).max() / np.abs(yb).max())
        report["dia-stencil"] = err
        assert err < rtol, ("dia-stencil", err)
    return report


def run_lab(
    mesh: Mesh,
    formats=None,
    cache_warming: int = 5,
    dtype=np.float32,
    json_path: str | None = None,
    box=None,
) -> dict:
    """Timed assembly runs per format (run-benchmark.sh semantics:
    CACHE_WARMING repeats, per-phase stats, JSON dump).  ``box`` (a
    StructuredBox matching the mesh) enables the dia-stencil strategy."""
    timer = PhaseTimer(verbose=False)
    with timer.phase("build-topology"):
        topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)

    coords = jnp.asarray(mesh.coords.astype(dtype))
    conns = {ct: jnp.asarray(c) for ct, c in mesh.cells.items()}

    stats = {
        "nbNode": mesh.n_nodes,
        "nbElement": mesh.n_cells,
        "nnz": topo.nnz,
        "ell_width": topo.width,
        "cache_warming": cache_warming,
        # the reference lab has 11 strategies (testlab/FemModule.cc:166-254);
        # the 4 not represented here are its hand-written GPU-atomic
        # kernels (coo-gpu, coo-sort-gpu, csr-gpu atomicAdd) and the legacy
        # DOK map — here bell-scatter/bell-segsum lower to XLA's own
        # atomic scatter-add on the GPU
        "strategies_not_represented": [
            "legacy-dok", "coo-gpu-atomic", "coo-sort-gpu-atomic",
            "csr-gpu-atomic",
        ],
        "formats": {},
    }
    names = list(formats) if formats else (
        list(FORMATS) + (list(STRUCTURED_FORMATS) if box is not None else [])
    )
    for name in names:
        if name in STRUCTURED_FORMATS:
            if box is None:
                raise ValueError(
                    f"'{name}' needs a structured mesh (run with --box)")
            c3d = coords.reshape(box.nx + 1, box.ny + 1, box.nz + 1, 3)

            @jax.jit
            def assemble(c3d):
                return box.assemble_stiffness(c3d).bands

            _, _, best = time_call(assemble, c3d, reps=cache_warming)
            stats["formats"][name] = {
                "lhs-matrix-assembly": best,
                "mdof_per_s": mesh.n_nodes / best / 1e6,
            }
            continue
        fn = FORMATS[name]

        @jax.jit
        def assemble(coords):
            mats = {
                ct: elements.stiffness(ct, coords[conns[ct]])
                for ct in conns
            }
            return fn(topo, mats, dtype).values

        _, _, best = time_call(assemble, coords, reps=cache_warming)
        stats["formats"][name] = {
            "lhs-matrix-assembly": best,
            "mdof_per_s": mesh.n_nodes / best / 1e6,
        }

    stats["time_stats"] = timer.stats
    if json_path:
        with open(json_path, "w") as f:
            json.dump(stats, f, indent=2)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="assembly-format laboratory")
    p.add_argument("--mesh", help=".msh file (default: generated box)")
    p.add_argument("--box", type=int, default=0, help="generated box n^3")
    p.add_argument("--rect", type=int, default=0, help="generated rect n^2")
    p.add_argument("--formats", default="",
                   help="comma list (default: all applicable, incl. "
                        "dia-stencil on generated boxes)")
    p.add_argument("--cache-warming", type=int, default=5)
    p.add_argument("--json", dest="json_path")
    p.add_argument("--cross-validate", action="store_true")
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)

    from .utils import device

    device.setup(cpu=device.cpu_pinned(), x64=args.f64)

    box = None
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif args.rect:
        mesh = rect_tria_mesh(args.rect, args.rect)
    else:
        from .mesh.structured import StructuredBox

        n = args.box or 20
        box = StructuredBox(n, n, n)
        mesh = box_tetra_mesh(n, n, n)

    if args.cross_validate:
        report = cross_validate(
            mesh, dtype=np.float64 if args.f64 else np.float32,
            rtol=CROSS_RTOL[np.float64 if args.f64 else np.float32], box=box)
        print(json.dumps({"cross_validation_max_rel": report}))
        return

    fmts = args.formats.split(",") if args.formats else None
    stats = run_lab(
        mesh,
        formats=fmts,
        cache_warming=args.cache_warming,
        dtype=np.float64 if args.f64 else np.float32,
        json_path=args.json_path,
        box=box,
    )
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
