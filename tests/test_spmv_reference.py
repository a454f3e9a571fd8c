"""The SpMV operators that stay — BELL (unstructured, blocked) and DIA
(structured) — against scipy CSR in float64, and the precision policy of
the solve path's contractions (utils/device.setup pins HIGHEST)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from arcanefem_tpu.mesh.generate import box_tetra_mesh, rect_tria_mesh
from arcanefem_tpu.sparse.bell import BellMatrix
from arcanefem_tpu.sparse.topology import build_topology
from chip_smoke import SPMV_TOL, dia_csr, spmv_error


def _sphere_cut():
    from arcanefem_tpu.mesh.unstructured import sphere_cut_tetra_mesh

    return sphere_cut_tetra_mesh(h=14.0)


MESHES = {
    "rect": lambda: rect_tria_mesh(9, 7),
    "box": lambda: box_tetra_mesh(5, 4, 3),
    "sphere_cut": _sphere_cut,
}


def _random_bell(mesh, b, dtype, seed=0):
    """BellMatrix with random blocks on the stored slots (zeros on pads)
    and its scalar-expanded float64 scipy CSR."""
    topo = build_topology(mesh.n_nodes, mesh.cells, pad_width_to=8)
    rng = np.random.default_rng(seed)
    N, W = topo.n_nodes, topo.width
    vals = rng.standard_normal((N, W, b, b))
    vals *= np.asarray(topo.ell_valid)[:, :, None, None]
    vals = vals.astype(dtype)
    blocks = vals.astype(np.float64).reshape(N * W, b, b)[topo.csr_to_ell]
    rows = np.repeat(np.arange(N), np.diff(topo.row_ptr))
    r = rows[:, None, None] * b + np.arange(b)[None, :, None]
    c = topo.csr_cols[:, None, None] * b + np.arange(b)[None, None, :]
    ref = sp.coo_matrix(
        (blocks.reshape(-1),
         (np.broadcast_to(r, blocks.shape).reshape(-1),
          np.broadcast_to(c, blocks.shape).reshape(-1))),
        shape=(N * b, N * b)).tocsr()
    A = BellMatrix(values=jnp.asarray(vals), topo=topo, block=b,
                   cols=jnp.asarray(topo.ell_cols))
    return A, ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_bell_spmv_matches_scipy(mesh_name, b, dtype):
    A, ref = _random_bell(MESHES[mesh_name](), b, dtype)
    x = np.random.default_rng(1).standard_normal(A.n_dofs).astype(dtype)
    y = jax.jit(lambda A, v: A.spmv(v))(A, jnp.asarray(x))
    assert y.dtype == dtype and y.shape == (A.n_dofs,)
    assert spmv_error(np.asarray(y), ref, x) <= SPMV_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [3, 6, (5, 4, 7)])
def test_dia_spmv_matches_scipy(n, dtype):
    from arcanefem_tpu.mesh.structured import StructuredBox

    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    box = StructuredBox(nx, ny, nz)
    c3d = jnp.asarray(box.grid_coords(dtype, jitter=0.1))
    A = box.assemble_stiffness(c3d)
    assert A.bands.dtype == dtype
    x = np.random.default_rng(2).random(box.n_nodes).astype(dtype)
    y = np.asarray(jax.jit(lambda A, v: A.spmv(v))(A, jnp.asarray(x)))
    ref = dia_csr(np.asarray(A.bands), A.offsets)
    assert spmv_error(y, ref, x) <= SPMV_TOL[dtype]


def test_spmv_error_flags_tf32_rounding():
    """The tolerance separates f32 from TF32: a 10-bit-mantissa product
    error is caught."""
    A, ref = _random_bell(box_tetra_mesh(4, 4, 4), 1, np.float64)
    x = np.random.default_rng(3).standard_normal(A.n_dofs)
    y = ref @ x
    assert spmv_error(y, ref, x) <= SPMV_TOL[np.float64]
    y_tf32 = y + 2.0**-11 * (abs(ref) @ np.abs(x))
    assert spmv_error(y_tf32, ref, x) > SPMV_TOL[np.float32]


def _dot_precisions(fn, *args) -> list[str]:
    txt = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in txt.splitlines() if "dot_general" in ln]
    assert lines, "no dot_general in the lowered program"
    return [re.search(r"precision = \[(\w+), (\w+)\]", ln).group(1)
            for ln in lines]


def _small_amg():
    from arcanefem_tpu.fem.problem import FemProblem
    from arcanefem_tpu.ops import elements
    from arcanefem_tpu.solver.amg import build_amg

    mesh = box_tetra_mesh(7, 7, 7)
    prob = FemProblem(mesh, ndof=1, dtype=np.float32)
    A = prob.assemble_matrix(lambda ct, xyz: elements.stiffness(ct, xyz))
    d = np.asarray(A.diagonal()).copy()
    vals = A.flat_values().reshape(-1)
    didx = jnp.asarray(A.topo.diag_slot)
    A = A.with_values(vals.at[didx].set(jnp.asarray(d + 1e-3)))
    return A, build_amg(A, coarse_size=50)


def _case_bell_spmv():
    A, _ = _random_bell(box_tetra_mesh(3, 3, 3), 1, np.float32)
    return (lambda A, v: A.spmv(v)), A, jnp.ones(A.n_dofs, jnp.float32)


def _case_block_jacobi():
    from arcanefem_tpu.solver.iterative import make_precond

    A, _ = _random_bell(box_tetra_mesh(3, 3, 3), 3, np.float32)
    M = make_precond(A, "block-jacobi")
    return (lambda M, r: M.apply(r)), M, jnp.ones(A.n_dofs, jnp.float32)


def _case_amg_vcycle():
    A, M = _small_amg()
    assert len(M.mats) >= 2
    return (lambda M, r: M.apply(r)), M, jnp.ones(A.n_dofs, jnp.float32)


def _case_gmres():
    from arcanefem_tpu.solver.iterative import Precond, gmres

    A, _ = _random_bell(box_tetra_mesh(3, 3, 3), 1, np.float32)
    b = jnp.ones(A.n_dofs, jnp.float32)
    M = Precond(data=(), kind="none")
    return (lambda A, b: gmres(A, b, M, jnp.zeros_like(b), 1e-6, 0.0, 10,
                               restart=4)), A, b


@pytest.mark.parametrize("case", [_case_bell_spmv, _case_block_jacobi,
                                  _case_amg_vcycle, _case_gmres])
def test_solve_path_contractions_use_highest_precision(case):
    """f32 contractions of the solve path lower with HIGHEST precision, so
    the GPU never runs them in TF32."""
    fn, *args = case()
    assert set(_dot_precisions(fn, *args)) == {"HIGHEST"}


@pytest.mark.gpu
def test_f32_spmv_on_gpu_matches_scipy():
    """On the card: the f32 BELL SpMV stays within f32 rounding (a TF32
    contraction would not)."""
    from arcanefem_tpu.mesh.unstructured import refine_tetra

    A, ref = _random_bell(refine_tetra(_sphere_cut()), 1, np.float32)
    x = np.random.default_rng(4).random(A.n_dofs).astype(np.float32)
    y = jax.jit(lambda A, v: A.spmv(v))(A, jnp.asarray(x))
    assert spmv_error(np.asarray(y), ref, x) <= SPMV_TOL[np.float32]
