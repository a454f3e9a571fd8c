"""Persistent Gauss-point state (ops/gauss_state.py) — the
GaussDoFsOnCells role (femutils/GaussDoFsOnCells.h:63-69)."""

import numpy as np
import jax.numpy as jnp

from arcanefem_tpu.mesh.generate import box_tetra_mesh
from arcanefem_tpu.ops import quadrature as Q
from arcanefem_tpu.ops.gauss_state import GaussState


def _state(ninteg=2):
    mesh = box_tetra_mesh(3, 3, 3)
    coords = jnp.asarray(mesh.coords)
    return mesh, coords, GaussState.build(mesh, coords, ninteg=ninteg, dim=3)


def test_state_matches_direct_iso_assembly():
    mesh, coords, st = _state()
    xyz = coords[jnp.asarray(mesh.cells["tetra4"])]
    lam, mu = 1.7, 0.9
    ref_k = np.asarray(Q.stiffness_blocks_iso("tetra4", xyz, lam, mu, 3))
    got_k = np.asarray(st.stiffness_blocks("tetra4", lam, mu))
    np.testing.assert_allclose(got_k, ref_k, rtol=1e-12, atol=1e-13)
    ref_m = np.asarray(Q.mass_blocks_iso("tetra4", xyz, 2.5, 3))
    got_m = np.asarray(st.mass_blocks("tetra4", 2.5))
    np.testing.assert_allclose(got_m, ref_m, rtol=1e-12, atol=1e-13)


def test_wdet_sums_to_volume():
    mesh, coords, st = _state()
    vol = float(jnp.sum(st.buckets["tetra4"].wdet))
    assert np.isclose(vol, 1.0, rtol=1e-12)  # unit box


def test_strain_of_linear_field_is_exact():
    mesh, coords, st = _state()
    # u(x) = B x with symmetric part E -> strain == E at every Gauss point
    B = np.array([[0.1, 0.3, 0.0], [0.1, -0.2, 0.05], [0.0, 0.01, 0.4]])
    E = 0.5 * (B + B.T)
    u = (np.asarray(coords) @ B.T).reshape(-1)
    eps = np.asarray(st.strain("tetra4", mesh.cells["tetra4"], jnp.asarray(u)))
    np.testing.assert_allclose(
        eps, np.broadcast_to(E, eps.shape), rtol=1e-10, atol=1e-12
    )
    # stress of that field: lam*tr(E)*I + 2 mu E
    lam, mu = 2.0, 0.7
    sig = np.asarray(
        st.stress("tetra4", mesh.cells["tetra4"], jnp.asarray(u), lam, mu)
    )
    want = lam * np.trace(E) * np.eye(3) + 2 * mu * E
    np.testing.assert_allclose(
        sig, np.broadcast_to(want, sig.shape), rtol=1e-10, atol=1e-12
    )


def test_passmo_still_matches_golden(reference_dir):
    """The GaussState rewiring must not change passmo results."""
    from arcanefem_tpu.fem.runner import run_case

    res = run_case(
        f"{reference_dir}/modules/passmo/inputs/bar3d_tetra_hexa_pyramids.arc"
    )
    assert res is not None
