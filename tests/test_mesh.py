import glob

import numpy as np
import pytest

from arcanefem_tpu.mesh import box_tetra_mesh, read_msh, rect_tria_mesh
from conftest import REFERENCE

MESHES = sorted(glob.glob(f"{REFERENCE}/meshes/msh/*.msh"))


def test_circle_cut(reference_dir):
    m = read_msh(f"{reference_dir}/meshes/msh/circle_cut.msh")
    assert m.dim == 2
    assert m.n_nodes == 101
    assert m.cells["tria3"].shape == (166, 3)
    assert set(m.face_groups) == {"curved", "horizontal", "vertical"}
    assert "domain" in m.cell_groups
    # uids are the 1-based gmsh tags (golden files key on them)
    assert m.node_uids[0] == 1 and m.node_uids[-1] == 101
    # all connectivity indices are valid
    assert m.cells["tria3"].max() < m.n_nodes


@pytest.mark.parametrize("path", MESHES, ids=lambda p: p.split("/")[-1])
def test_parse_all_reference_meshes(path):
    m = read_msh(path)
    assert m.n_nodes > 0
    assert m.n_cells > 0
    for conn in m.cells.values():
        assert conn.min() >= 0 and conn.max() < m.n_nodes


def test_boundary_faces_sphere(reference_dir):
    m = read_msh(f"{reference_dir}/meshes/msh/sphere_cut.msh")
    bf = m.boundary_faces()
    # every boundary node should be in some physical face group too
    group_nodes = np.unique(
        np.concatenate([c.ravel() for g in m.face_groups.values() for c in g.values()])
    )
    bnodes = np.unique(np.concatenate([c.ravel() for c in bf.values()]))
    assert set(bnodes) == set(group_nodes)


def test_structured_meshes():
    m = rect_tria_mesh(4, 3)
    assert m.n_nodes == 20
    assert m.cells["tria3"].shape == (24, 3)
    m3 = box_tetra_mesh(3, 3, 3)
    assert m3.n_nodes == 64
    assert m3.cells["tetra4"].shape == (27 * 6, 4)
    # total volume = 1
    from arcanefem_tpu.ops.geometry import tetra4_volume
    import jax.numpy as jnp

    xyz = jnp.asarray(m3.coords)[jnp.asarray(m3.cells["tetra4"])]
    assert np.isclose(float(tetra4_volume(xyz).sum()), 1.0)
