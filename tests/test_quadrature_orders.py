"""Gauss-rule exactness for ninteg 1-4 (GaussQuadrature.h:44-316 parity).

Each rule must integrate monomials up to its design degree exactly on the
reference cell; degrees follow the reference's order->points tables
(1D/quad/hexa: Gauss-Legendre 2n-1; triangle n; tetra n with the 15-point
order-4 rule reaching degree 5; penta/pyramid conical products).
"""

import math
from itertools import product

import numpy as np
import pytest

from arcanefem_tpu.ops.quadrature import rule, shape_tables

CELLS = [
    "line2", "tria3", "quad4", "tetra4", "hexa8", "penta6", "pyramid5",
]


def _simplex2_exact(a, b):
    return (
        math.factorial(a) * math.factorial(b) / math.factorial(a + b + 2)
    )


def _simplex3_exact(a, b, c):
    return (
        math.factorial(a) * math.factorial(b) * math.factorial(c)
        / math.factorial(a + b + c + 3)
    )


def _interval_exact(a):
    return 0.0 if a % 2 else 2.0 / (a + 1)


def _pyramid_exact(a, b, c):
    # base (±(1−z), ±(1−z)) at height z: ∫ x^a y^b z^c over the pyramid
    if a % 2 or b % 2:
        return 0.0
    beta = (
        math.factorial(c) * math.factorial(a + b + 2)
        / math.factorial(a + b + c + 3)
    )
    return beta * 4.0 / ((a + 1) * (b + 1))


def _exact(ct, exps):
    if ct == "line2":
        return _interval_exact(exps[0])
    if ct == "tria3":
        return _simplex2_exact(*exps)
    if ct == "quad4":
        return _interval_exact(exps[0]) * _interval_exact(exps[1])
    if ct == "tetra4":
        return _simplex3_exact(*exps)
    if ct == "hexa8":
        return np.prod([_interval_exact(e) for e in exps])
    if ct == "penta6":
        return _simplex2_exact(exps[0], exps[1]) * _interval_exact(exps[2])
    if ct == "pyramid5":
        return _pyramid_exact(*exps)
    raise AssertionError(ct)


def _degree(ct, n):
    if ct in ("line2", "quad4", "hexa8"):
        return 2 * n - 1
    if ct == "tria3":
        return n
    if ct == "tetra4":
        return 5 if n == 4 else n
    if ct == "penta6":
        return min(n, 2 * n - 1)
    if ct == "pyramid5":
        return 2 * n - 1
    raise AssertionError(ct)


@pytest.mark.parametrize("ct", CELLS)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_monomial_exactness(ct, n):
    pts, wts = rule(ct, n)
    rdim = pts.shape[1]
    deg = _degree(ct, n)
    for exps in product(range(deg + 1), repeat=rdim):
        if sum(exps) > deg:
            continue
        if ct == "pyramid5" and max(exps[:2], default=0) > 2 * n - 1:
            continue
        got = float(np.sum(wts * np.prod(pts**np.array(exps), axis=1)))
        want = float(_exact(ct, exps))
        assert got == pytest.approx(want, abs=2e-14), (
            f"{ct} ninteg={n}: ∫ x^{exps} = {got}, want {want}"
        )


@pytest.mark.parametrize("ct", CELLS + ["tria6", "tetra10", "quad8", "hexa20"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_of_unity_all_orders(ct, n):
    """Shape tables at every rule's points still sum to one (consistency of
    shape evaluation with the new point sets)."""
    N, dN = shape_tables(ct, n)
    np.testing.assert_allclose(N.sum(axis=1), 1.0, atol=1e-13)
    np.testing.assert_allclose(dN.sum(axis=1), 0.0, atol=1e-12)


def test_rules_out_of_range():
    with pytest.raises(NotImplementedError):
        rule("tetra4", 5)
    with pytest.raises(NotImplementedError):
        rule("tria3", 0)


def test_passmo_runs_at_ninteg_3(reference_dir):
    """A reference passmo case re-run with gauss-nint=3 must agree with the
    default order-2 run (P1/P2 straight-sided elements: both rules exact
    for the stiffness; mass differences vanish well under golden epsilon)."""
    import glob

    from arcanefem_tpu.fem.arc import load_case
    from arcanefem_tpu.fem.runner import run_case
    from arcanefem_tpu.models import passmo

    arcs = glob.glob(f"{reference_dir}/modules/passmo/inputs/bar2d*.arc")
    arc = sorted(arcs)[0]
    case = load_case(arc)
    r2 = run_case(arc)
    # rebuild the config with ninteg=3 through the same .arc plumbing
    from arcanefem_tpu.mesh.core import read_msh

    mesh = read_msh(case.mesh_file)
    cfg = passmo.config_from_case(case)
    cfg.ninteg = 3
    cfg.result_file = None
    r3 = passmo.solve(mesh, cfg)
    np.testing.assert_allclose(r3.u, r2.u, rtol=1e-4, atol=1e-10)
