"""VTKHDF writer: on-disk layout, temporal steps, run_case integration.

Validates the structure ParaView's VTKHDF reader expects (VTK HDF File
Format v2.0, UnstructuredGrid) by reopening with h5py and checking the
datasets/attributes, since VTK itself is not available in this image.
"""

import numpy as np
import pytest

from arcanefem_tpu.fem.vtkhdf import HAVE_H5PY, VtkHdfWriter, write_vtkhdf
from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh

pytestmark = pytest.mark.skipif(not HAVE_H5PY, reason="h5py not available")


def _open(path):
    import h5py

    return h5py.File(path, "r")


def test_snapshot_layout_2d(tmp_path):
    mesh = rect_tria_mesh(4, 3)
    u = np.linspace(0.0, 1.0, mesh.n_nodes)
    disp = np.stack([u, 2 * u], axis=1)  # 2-comp vector -> padded to 3
    out = str(tmp_path / "snap.hdf")
    write_vtkhdf(out, mesh, point_data={"U": u, "D": disp})
    with _open(out) as f:
        g = f["VTKHDF"]
        assert list(g.attrs["Version"]) == [2, 0]
        assert g.attrs["Type"] in (b"UnstructuredGrid", "UnstructuredGrid")
        assert g["NumberOfPoints"][0] == mesh.n_nodes
        assert g["NumberOfCells"][0] == mesh.n_cells
        conn = g["Connectivity"][:]
        off = g["Offsets"][:]
        assert off[0] == 0 and off[-1] == conn.size
        assert g["NumberOfConnectivityIds"][0] == conn.size
        # every tria3 offset stride is 3
        assert set(np.diff(off)) == {3}
        assert set(g["Types"][:]) == {5}  # VTK_TRIANGLE
        assert g["Points"].shape == (mesh.n_nodes, 3)
        np.testing.assert_allclose(g["PointData/U"][:], u)
        d = g["PointData/D"][:]
        assert d.shape == (mesh.n_nodes, 3)
        np.testing.assert_allclose(d[:, 2], 0.0)
        np.testing.assert_allclose(d[:, :2], disp)


def test_snapshot_cell_data_3d(tmp_path):
    mesh = box_tetra_mesh(2, 2, 2)
    cd = {ct: np.arange(c.shape[0], dtype=float)
          for ct, c in mesh.cells.items()}
    out = str(tmp_path / "cells.hdf")
    write_vtkhdf(out, mesh, cell_data={"rank": cd})
    with _open(out) as f:
        g = f["VTKHDF"]
        assert set(g["Types"][:]) == {10}  # VTK_TETRA
        assert g["CellData/rank"].shape == (mesh.n_cells,)
        assert set(np.diff(g["Offsets"][:])) == {4}


def test_temporal_steps(tmp_path):
    mesh = rect_tria_mesh(3, 3)
    out = str(tmp_path / "transient.hdf")
    with VtkHdfWriter(out, mesh) as w:
        for i in range(4):
            w.add_step(0.1 * i, point_data={"T": np.full(mesh.n_nodes, i)})
    with _open(out) as f:
        g = f["VTKHDF"]
        s = g["Steps"]
        assert s.attrs["NSteps"] == 4
        np.testing.assert_allclose(s["Values"][:], [0.0, 0.1, 0.2, 0.3])
        # static geometry: all per-step geometry offsets are zero
        assert not s["PointOffsets"][:].any()
        assert not s["CellOffsets"][:].any()
        assert not s["ConnectivityIdOffsets"][:].any()
        # field grows along axis 0; per-step slab offsets n*npoints
        assert g["PointData/T"].shape == (4 * mesh.n_nodes,)
        np.testing.assert_array_equal(
            s["PointDataOffsets/T"][:], np.arange(4) * mesh.n_nodes
        )
        # step 2's slab holds the value 2 everywhere
        o = int(s["PointDataOffsets/T"][2])
        np.testing.assert_allclose(
            g["PointData/T"][o:o + mesh.n_nodes], 2.0
        )


def test_run_case_output_dir(tmp_path, reference_dir):
    from arcanefem_tpu.fem.runner import run_case

    case = f"{reference_dir}/modules/poisson/inputs/circle.2D.arc"
    res = run_case(case, output_dir=str(tmp_path))
    out = tmp_path / "circle.2D.hdf"
    assert out.exists()
    with _open(str(out)) as f:
        u = f["VTKHDF/PointData/U"][:]
        assert u.shape == (res.u.shape[0],)
        np.testing.assert_allclose(u, res.u)


def test_run_case_transient_history(tmp_path, reference_dir):
    """heat + keep_history -> ONE temporal VTKHDF holding every step."""
    from arcanefem_tpu.fem.runner import run_case

    case = f"{reference_dir}/modules/heat/inputs/conduction.arc"
    res = run_case(case, output_dir=str(tmp_path), keep_history=True)
    assert res.history
    with _open(str(tmp_path / "conduction.hdf")) as f:
        g = f["VTKHDF"]
        n = g["Steps"].attrs["NSteps"]
        assert n == len(res.history)
        npoints = int(g["NumberOfPoints"][0])
        assert g["PointData/NodeTemperature"].shape[0] == n * npoints
        # last slab equals the final temperature field
        np.testing.assert_allclose(
            g["PointData/NodeTemperature"][-npoints:], res.T
        )
        np.testing.assert_allclose(
            g["Steps/Values"][:], [t for t, _ in res.history]
        )
