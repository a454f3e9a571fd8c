"""CLI entry point + checkpoint/resume."""

import numpy as np

from arcanefem_tpu.__main__ import main
from arcanefem_tpu.fem import checkpoint


def test_cli_run_case(capsys, reference_dir):
    rc = main(["run", f"{reference_dir}/modules/poisson/inputs/circle.2D.arc"])
    assert rc == 0
    assert "PoissonResult" in capsys.readouterr().out


def test_cli_testlab(capsys):
    main(["testlab", "--rect", "10", "--cross-validate"])
    assert "cross_validation_max_rel" in capsys.readouterr().out


def test_checkpoint_roundtrip(tmp_path):
    state = {"U": np.arange(6.0), "V": np.ones((3, 2))}
    checkpoint.save(str(tmp_path / "ck"), 0.75, 3, state)
    t, step, got = checkpoint.restore(str(tmp_path / "ck"))
    assert t == 0.75 and step == 3
    np.testing.assert_array_equal(got["U"], state["U"])
    np.testing.assert_array_equal(got["V"], state["V"])


def test_heat_resume_matches_continuous(tmp_path):
    """Stopping and resuming a transient run reproduces the continuous run
    (the Arcane checkpoint/resume role, SURVEY.md §5)."""
    import jax.numpy as jnp

    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu.mesh.generate import rect_tria_mesh
    from arcanefem_tpu.models import heat as H
    from arcanefem_tpu.solver.linear_system import SolverOptions

    mesh = rect_tria_mesh(8, 5)
    bcs = BoundaryConditions(dirichlet=[DirichletBC("left", 1.0)])
    base = dict(lam=1.0, Tinit=0.0, dt=0.25, bcs=bcs,
                solver=SolverOptions(rtol=1e-12))

    full = H.solve(mesh, H.HeatConfig(tmax=2.0, **base))

    half = H.solve(mesh, H.HeatConfig(tmax=1.0, **base))
    checkpoint.save(str(tmp_path / "ck"), 1.0, half.steps, {"T": half.T})
    t0, _s, st = checkpoint.restore(str(tmp_path / "ck"))
    resumed = H.solve(
        mesh, H.HeatConfig(tmax=2.0 - t0, Tinit=0.0, lam=1.0, dt=0.25,
                           bcs=bcs, solver=SolverOptions(rtol=1e-12)),
        T0=st["T"],
    )
    np.testing.assert_allclose(resumed.T, full.T, rtol=1e-9, atol=1e-12)


def test_vtk_writer(tmp_path):
    """VTK legacy output readable structure (the post-processing role)."""
    from arcanefem_tpu.fem.vtk import write_vtk
    from arcanefem_tpu.mesh.generate import rect_tria_mesh

    mesh = rect_tria_mesh(3, 2)
    u = np.linspace(0, 1, mesh.n_nodes)
    vec = np.stack([u, -u], axis=1)
    path = tmp_path / "out.vtk"
    write_vtk(str(path), mesh, point_data={"u": u, "grad": vec},
              cell_data={"rho": np.ones(mesh.n_cells)})
    text = path.read_text()
    assert "UNSTRUCTURED_GRID" in text
    assert f"POINTS {mesh.n_nodes} double" in text
    assert "SCALARS u double 1" in text
    assert "VECTORS grad double" in text
    assert f"CELL_DATA {mesh.n_cells}" in text
