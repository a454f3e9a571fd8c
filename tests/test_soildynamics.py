"""Soildynamics: golden-file regression (paraxial + double-couple) plus
absorbing-boundary physics checks."""

import glob

import numpy as np
import pytest

from arcanefem_tpu.fem.runner import run_case
from conftest import REFERENCE

CASES = sorted(glob.glob(f"{REFERENCE}/modules/soildynamics/inputs/*.arc"))


@pytest.mark.parametrize("arc", CASES, ids=lambda p: p.split("/")[-1])
def test_soildynamics_case(arc):
    try:
        r = run_case(arc)
    except FileNotFoundError as e:
        pytest.skip(str(e))
    assert np.all(np.isfinite(r.u))


def test_paraxial_absorbs_energy(reference_dir):
    """With paraxial boundaries on all sides, the oscillating double-couple
    source radiates waves that leave the domain: the displacement field at
    late times must be far below its early peak (without absorption the
    domain would keep ringing)."""
    from arcanefem_tpu.fem.arc import load_case
    from arcanefem_tpu.mesh.core import read_msh
    from arcanefem_tpu.models import soildynamics as SD

    case = load_case(
        f"{reference_dir}/modules/soildynamics/inputs/double-couple.paraxial.arc"
    )
    mesh = read_msh(case.mesh_file)
    case.fem.find("tmax").text = "0.5"
    u_peak = np.abs(SD._run_arc(case, mesh, check=False).u).max()
    case2 = load_case(case.path)
    case2.fem.find("tmax").text = "2.0"
    u_late = np.abs(SD._run_arc(case2, mesh, check=False).u).max()
    assert u_late < 0.2 * u_peak, (u_peak, u_late)
