"""chip_smoke.py's phases at tiny sizes on the CPU, its host references,
and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from arcanefem_tpu.mesh.generate import box_tetra_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def unstructured_state():
    return cs.phase_unstructured(h=14.0, refine=0, expect_iters=None)


def test_phase_unstructured(unstructured_state):
    assert unstructured_state["iters32"] > 0
    assert np.isfinite(unstructured_state["x32"]).all()


def test_phase_fp64(unstructured_state):
    cs.phase_fp64(unstructured_state, expect_iters=None)


def test_phase_structured():
    cs.phase_structured(n=8)


def test_phase_testlab(capsys):
    cs.phase_testlab(box_n=5)
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(report["cross_validation_max_rel"]) >= {"bell-segsum",
                                                        "dia-stencil"}


def test_phase_four_unstructured():
    cs.phase_four_unstructured(h=14.0, refine=0, n_dev=4)


def test_phase_four_structured():
    cs.phase_four_structured(n=8, n_dev=4)


@pytest.mark.parametrize("mesh", [
    box_tetra_mesh(3, 2, 2),
    box_tetra_mesh(4, 4, 3, 2.0, 1.0, 0.5),
])
def test_reference_stiffness_matches_generic_assembly(mesh):
    """The f64 host reference agrees with the library's generic f64
    element-kernel assembly to f64 rounding."""
    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.ops import elements

    prob = FemProblem(mesh, ndof=1, dtype=np.float64)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    got = cs.bell_csr(np.asarray(A.values), A.topo)
    ref = cs.reference_stiffness(mesh.coords, mesh.cells["tetra4"])
    assert np.array_equal(got.indices, ref.indices)
    assert cs.row_scaled_error(got, ref) < 1e-12


def test_reference_structured_bands_match_dia_assembly():
    import jax.numpy as jnp

    from arcanefem_tpu.mesh.structured import StructuredBox

    box = StructuredBox(4, 3, 5)
    c = box.grid_coords(np.float64, jitter=0.1)
    got = np.asarray(box.assemble_stiffness(jnp.asarray(c)).bands)
    np.testing.assert_allclose(got, cs.reference_structured_bands(box, c),
                               rtol=0, atol=1e-13)


def _run(script_dir, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=script_dir, env=env,
        capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    proc = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), {"JAX_PLATFORMS": "cpu",
                                "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
