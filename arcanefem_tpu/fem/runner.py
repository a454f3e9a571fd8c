"""Case runner: codename -> model dispatch.

The reference builds one executable per module with an Arcane time loop
(modules/*/main.cc + <Name>.config); here each model registers a
``run(case, mesh, dtype)`` callable and `run_case` plays the role of the
ArcaneLauncher (SURVEY.md §3.1 call stack).
"""

from __future__ import annotations

from typing import Callable

from ..mesh.core import read_msh
from .arc import load_case

_REGISTRY: dict[str, Callable] = {}


def register(codename: str):
    def deco(fn):
        # case-insensitive: reference case files are inconsistent
        # (codename="aerodynamics" vs "Poisson")
        _REGISTRY[codename.lower()] = fn
        return fn

    return deco


# declared .arc output-variable name -> result-object attributes to try
# (reference variable names per module: U/V/A displacement-velocity-accel,
# NodeTemperature for heat, Displ for passmo, Phi/E electrostatics, psi
# aerodynamics, u1/u2 bilaplacian)
_VAR_ALIASES = {
    "u": ("u",), "v": ("v",), "a": ("a",),
    "nodetemperature": ("T", "u"), "displ": ("u",),
    "phi": ("phi",), "e": ("E",), "psi": ("psi",), "flux": ("flux",),
    "u1": ("u1",), "u2": ("u2",),
    # passmo recovery cell variables (Elastodynamic.axl:41-52)
    "strainvol": ("strain_vol",), "straindev": ("strain_dev",),
    "stressvol": ("stress_vol",), "stressdev": ("stress_dev",),
}


def _write_post_processing(case, mesh, res, output_dir: str):
    """Emit the case's `<arcane-post-processing>` variables as a VTKHDF
    file (the reference's VtkHdfV2PostProcessor output), falling back to
    legacy ASCII VTK when h5py is unavailable."""
    import os

    import numpy as np

    point_data, cell_data = {}, {}
    for name in case.post_processing.variables:
        attrs = _VAR_ALIASES.get(name.lower(), (name, name.lower()))
        val = next(
            (getattr(res, a) for a in attrs if getattr(res, a, None)
             is not None),
            None,
        )
        if val is None:
            continue  # derived-only variables (e.g. UExact) — no field held
        if isinstance(val, dict):
            cell_data[name] = val
        else:
            arr = np.asarray(val)
            (point_data if arr.shape[0] == mesh.n_nodes else cell_data)[
                name
            ] = arr
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(case.path))[0]
    from .vtkhdf import HAVE_H5PY, VtkHdfWriter, write_vtkhdf

    history = getattr(res, "history", None)
    if HAVE_H5PY:
        out = os.path.join(output_dir, stem + ".hdf")
        if history:
            # transient snapshots [(t, field)] -> one temporal VTKHDF file
            # (the reference writes every <output-period> steps; models
            # collect the same snapshots under keep_history=True)
            name = next(iter(point_data), "U")
            with VtkHdfWriter(out, mesh) as w:
                for t, snap in history:
                    w.add_step(float(t), point_data={name: snap})
        else:
            write_vtkhdf(out, mesh, point_data=point_data,
                         cell_data=cell_data)
    else:  # pragma: no cover
        from .vtk import write_vtk

        out = os.path.join(output_dir, stem + ".vtk")
        write_vtk(out, mesh, point_data=point_data, cell_data=cell_data)
    return out


def run_case(
    path: str,
    dtype=None,
    mesh_root: str | None = None,
    rcm: bool = False,
    verbose: bool = False,
    output_dir: str | None = None,
    **kw,
):
    """Load an .arc case, read its mesh, dispatch to the registered model.

    rcm: bandwidth-reducing node renumbering (utils/ordering.py) — golden
    validation is uid-keyed, so results are invariant; keeps the SpMV's
    gathers local on larger meshes.
    verbose: print `[ArcaneFem-Timer]` phase lines (the reference's
    per-phase wall-clock instrumentation, modules/poisson/FemModule.cc:28-39).
    output_dir: write the case's `<arcane-post-processing>` variables
    there as a VTKHDF file (fem/vtkhdf.py) after the run.
    """
    import numpy as np

    case = load_case(path, mesh_root=mesh_root)
    key = (case.codename or "").lower()
    if key not in _REGISTRY:
        # import model modules lazily so registration side-effects run
        from .. import models  # noqa: F401
        from ..models import _ALL  # triggers imports

        _ = _ALL
    if key not in _REGISTRY:
        raise KeyError(
            f"no model registered for codename '{case.codename}' "
            f"(have: {sorted(_REGISTRY)})"
        )
    mesh = read_msh(case.mesh_file)
    if rcm:
        from ..sparse.topology import build_topology
        from ..utils.ordering import rcm_order, renumber_mesh

        topo = build_topology(mesh.n_nodes, mesh.cells)
        mesh = renumber_mesh(
            mesh, rcm_order(mesh.n_nodes, topo.row_ptr, topo.csr_cols)
        )
    if verbose and "timer" not in kw:
        from .timer import PhaseTimer

        kw["timer"] = PhaseTimer(verbose=True)
    res = _REGISTRY[key](case, mesh, dtype=dtype or np.float64, **kw)
    if output_dir and case.post_processing is not None:
        out = _write_post_processing(case, mesh, res, output_dir)
        if verbose:
            print(f"[post-processing] wrote {out}")
    return res
