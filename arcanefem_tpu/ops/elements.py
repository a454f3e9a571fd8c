"""Batched element-matrix kernels.

Each function maps stacked cell vertex coordinates ``(nc, npc, 3)`` (plus
physics parameters) to stacked element matrices ``(nc, npc, npc)`` or
``(nc, npc, npc, b, b)`` — the batched counterparts of the reference's
per-cell ``_computeElementMatrix*`` FixedMatrix kernels.

The arithmetic intensity per element is tiny, so these fuse into the
assembly segment-sum; XLA keeps the element arithmetic in registers.
"""

from __future__ import annotations

import jax.numpy as jnp

from .geometry import (
    quad4_area,
    quad4_gradients,
    tria3_area,
    tria3_gradients,
    tetra4_gradients,
    tetra4_volume,
)


def stiffness_tria3(xyz: jnp.ndarray) -> jnp.ndarray:
    """∫ ∇u·∇v over P1 triangles: area·(dx⊗dx + dy⊗dy).

    Reference: modules/poisson/FemModule.h:126-134 (_computeElementMatrixTria3).
    """
    area = tria3_area(xyz)
    dx, dy = tria3_gradients(xyz)
    return area[:, None, None] * (
        dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
    )


def stiffness_tetra4(xyz: jnp.ndarray) -> jnp.ndarray:
    """∫ ∇u·∇v over P1 tets: V·(dx⊗dx + dy⊗dy + dz⊗dz).

    Reference: modules/poisson/FemModule.h:163-172 (_computeElementMatrixTetra4).
    """
    vol = tetra4_volume(xyz)
    dx, dy, dz = tetra4_gradients(xyz)
    return vol[:, None, None] * (
        dx[:, :, None] * dx[:, None, :]
        + dy[:, :, None] * dy[:, None, :]
        + dz[:, :, None] * dz[:, None, :]
    )


def stiffness_quad4(xyz: jnp.ndarray) -> jnp.ndarray:
    """One-point quad4 Laplacian: area·(dx⊗dx + dy⊗dy)
    (reference modules/fourier/FemModule.cc:237-245)."""
    area = quad4_area(xyz)
    dx, dy = quad4_gradients(xyz)
    return area[:, None, None] * (
        dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
    )


def stiffness_iso(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    """Scalar Laplace stiffness Σ_g w·|detJ|·∇N_i·∇N_j via the general
    isoparametric path — any zoo element incl. quadratic (tria6, tetra10,
    quad8, hexa20), the CellFEMDispatcher role
    (reference femutils/ArcaneFemFunctions.h:1224-2342)."""
    from .quadrature import REF_DIM, iso_geometry

    _, grads, wdet = iso_geometry(cell_type, xyz, REF_DIM[cell_type])
    return jnp.einsum("gc,gcid,gcjd->cij", wdet, grads, grads)


def stiffness(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    if cell_type == "tria3":
        return stiffness_tria3(xyz)
    if cell_type == "tetra4":
        return stiffness_tetra4(xyz)
    if cell_type == "quad4":
        return stiffness_quad4(xyz)
    from .quadrature import REF_DIM

    if cell_type in REF_DIM and not cell_type.startswith("line"):
        return stiffness_iso(cell_type, xyz)
    raise ValueError(f"no stiffness kernel for cell type '{cell_type}'")


def mass_tria3(xyz: jnp.ndarray) -> jnp.ndarray:
    """∫ u·v over P1 triangles: area·[[1/6,1/12,1/12],...]
    (computeUVTria3, ArcaneFemFunctions.h:648-660 scaled by area)."""
    area = tria3_area(xyz)
    aii, aij = 1.0 / 6.0, 1.0 / 12.0
    m = jnp.full((3, 3), aij, xyz.dtype) + (aii - aij) * jnp.eye(3, dtype=xyz.dtype)
    return area[:, None, None] * m[None]


def mass_tetra4(xyz: jnp.ndarray) -> jnp.ndarray:
    """∫ u·v over P1 tets: V/20·(1+δij)."""
    vol = tetra4_volume(xyz)
    m = (jnp.ones((4, 4), xyz.dtype) + jnp.eye(4, dtype=xyz.dtype)) / 20.0
    return vol[:, None, None] * m[None]


def mass(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    if cell_type == "tria3":
        return mass_tria3(xyz)
    if cell_type == "tetra4":
        return mass_tetra4(xyz)
    raise ValueError(f"no mass kernel for cell type '{cell_type}'")


def gradients(cell_type: str, xyz: jnp.ndarray):
    """Per-cell shape gradients (tuple of (nc, npc) arrays, one per axis)."""
    if cell_type == "tria3":
        return tria3_gradients(xyz)
    if cell_type == "quad4":
        return quad4_gradients(xyz)
    if cell_type == "tetra4":
        return tetra4_gradients(xyz)
    raise ValueError(f"no gradient kernel for cell type '{cell_type}'")


def measure(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    """Cell measure: area (2D) or volume (3D)."""
    if cell_type == "tria3":
        return tria3_area(xyz)
    if cell_type == "tetra4":
        return tetra4_volume(xyz)
    if cell_type == "quad4":
        return quad4_area(xyz)
    raise ValueError(f"no measure kernel for cell type '{cell_type}'")


def _grad_stack(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    """(nc, npc, d) stacked shape gradients."""
    return jnp.stack(gradients(cell_type, xyz), axis=-1)


def divdiv(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    """Unit-coefficient ∫(div u)(div v) vector blocks (nc,npc,npc,d,d):
    D[i,j,a,b] = meas · g[i,a] g[j,b].  The λ-part of the elasticity
    operator (reference elastodynamics RHS c5/c7/c8 terms,
    modules/elastodynamics/FemModule.cc:816-870)."""
    g = _grad_stack(cell_type, xyz)
    m = measure(cell_type, xyz)
    return m[:, None, None, None, None] * jnp.einsum("nia,njb->nijab", g, g)


def epseps(cell_type: str, xyz: jnp.ndarray) -> jnp.ndarray:
    """Unit-coefficient ∫ε(u):ε(v) vector blocks (nc,npc,npc,d,d):
    E[i,j,a,b] = meas/2 · (g[i,b] g[j,a] + δ_ab g_i·g_j).  The 2μ-part
    (c6/c9/c10 terms).  Note λ·divdiv + 2μ·epseps == elasticity blocks."""
    g = _grad_stack(cell_type, xyz)
    m = measure(cell_type, xyz)
    d = g.shape[-1]
    t1 = jnp.einsum("nib,nja->nijab", g, g)
    dot = jnp.einsum("nic,njc->nij", g, g)
    eye = jnp.eye(d, dtype=g.dtype)
    return 0.5 * m[:, None, None, None, None] * (
        t1 + dot[:, :, :, None, None] * eye[None, None, None]
    )


def mass_blocks(cell_type: str, xyz: jnp.ndarray, ndof: int) -> jnp.ndarray:
    """Consistent mass as vector blocks m_ij · I_ndof (nc,npc,npc,b,b)."""
    m = mass(cell_type, xyz)
    eye = jnp.eye(ndof, dtype=xyz.dtype)
    return m[:, :, :, None, None] * eye[None, None, None]


def edge2_mass(xyz: jnp.ndarray) -> jnp.ndarray:
    """Boundary-edge mass L/6·(1+δij) (nf,2,2): the convection matrix core
    (reference modules/heat/FemModule.cc:629-673, scaled there by h)."""
    from .geometry import edge2_length

    L = edge2_length(xyz)
    m = (jnp.ones((2, 2), xyz.dtype) + jnp.eye(2, dtype=xyz.dtype)) / 6.0
    return L[:, None, None] * m[None]


def elasticity_tria3(
    xyz: jnp.ndarray, lam: jnp.ndarray, mu2: jnp.ndarray
) -> jnp.ndarray:
    """Plane-strain linear elasticity 2-dof element blocks.

    Returns (nc, 3, 3, 2, 2) block element matrices equivalent to the
    reference's 6×6 FixedMatrix built from outer products
    (modules/elasticity/FemModule.h:112-143):
      K = λ (div u)(div v) + 2μ ε(u):ε(v), integrated over the triangle.
    lam, mu2 broadcast over cells; mu2 = 2μ.
    """
    area = tria3_area(xyz)
    dx, dy = tria3_gradients(xyz)  # (nc, 3)

    # Kxx[i,j] = λ dxj dxi + 2μ dxj dxi + μ dyj dyi etc. Derive from the
    # standard B^T D B for plane strain with D = [[λ+2μ, λ, 0],[λ, λ+2μ, 0],
    # [0,0,μ]].
    mu = mu2 / 2.0
    a = area[:, None, None]
    dxi, dxj = dx[:, :, None], dx[:, None, :]
    dyi, dyj = dy[:, :, None], dy[:, None, :]

    kxx = a * ((lam + mu2) * dxi * dxj + mu * dyi * dyj)
    kyy = a * ((lam + mu2) * dyi * dyj + mu * dxi * dxj)
    kxy = a * (lam * dxi * dyj + mu * dyi * dxj)
    kyx = a * (lam * dyi * dxj + mu * dxi * dyj)

    blocks = jnp.stack(
        [jnp.stack([kxx, kxy], axis=-1), jnp.stack([kyx, kyy], axis=-1)],
        axis=-2,
    )  # (nc, 3, 3, 2, 2)
    return blocks


def elasticity_tetra4(
    xyz: jnp.ndarray, lam: jnp.ndarray, mu2: jnp.ndarray
) -> jnp.ndarray:
    """3D linear elasticity 3-dof element blocks: (nc, 4, 4, 3, 3)."""
    vol = tetra4_volume(xyz)
    dx, dy, dz = tetra4_gradients(xyz)
    mu = mu2 / 2.0
    g = jnp.stack([dx, dy, dz], axis=-1)  # (nc, 4, 3)
    # K[i,j,a,b] = V (λ g[i,a] g[j,b] + μ g[i,b] g[j,a] + μ δ_ab (g_i·g_j))
    v = vol[:, None, None, None, None]
    term1 = lam * jnp.einsum("nia,njb->nijab", g, g)
    term2 = mu * jnp.einsum("nib,nja->nijab", g, g)
    dot_ij = jnp.einsum("nic,njc->nij", g, g)
    eye = jnp.eye(3, dtype=g.dtype)
    term3 = mu * dot_ij[:, :, :, None, None] * eye[None, None, None]
    return v * (term1 + term2 + term3)
