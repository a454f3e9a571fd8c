"""Batched element geometry (JAX, fully vectorised over cells).

JAX counterpart of the reference's per-cell geometry helpers
(reference femutils/ArcaneFemFunctions.h:40-432 ``MeshOperation`` and
:449-816 ``FeOperation2D/3D``; GPU twins in ArcaneFemFunctionsGpu.h).
Instead of one cell per GPU thread, every function takes the stacked
vertex coordinates of *all* cells of a bucket, shape ``(nc, npc, 3)``,
and returns per-cell arrays — XLA fuses the arithmetic into a handful
of elementwise kernels over HBM-contiguous arrays.

All functions are dtype-polymorphic (f32 or f64).
"""

from __future__ import annotations

import jax.numpy as jnp


def _cross(a, b):
    return jnp.cross(a, b, axis=-1)


def tria3_area(xyz: jnp.ndarray) -> jnp.ndarray:
    """Unsigned triangle area; (nc, 3, 3) -> (nc,).

    Mirrors computeAreaTria3 (ArcaneFemFunctions.h:84-95): 3D-robust
    cross-product formula, so triangles embedded in 3D work too.
    """
    v = _cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    return 0.5 * jnp.linalg.norm(v, axis=-1)


def tria3_area2_signed(xyz: jnp.ndarray) -> jnp.ndarray:
    """Twice the signed (z=0 planar) area: the 2A determinant used by the
    P1 gradient formulas (ArcaneFemFunctions.h:514-520)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (
        x[:, 2] - x[:, 0]
    ) * (y[:, 1] - y[:, 0])


def tetra4_volume6_signed(xyz: jnp.ndarray) -> jnp.ndarray:
    """6x signed tetra volume (scalar triple product)."""
    v0 = xyz[:, 1] - xyz[:, 0]
    v1 = xyz[:, 2] - xyz[:, 0]
    v2 = xyz[:, 3] - xyz[:, 0]
    return jnp.einsum("ni,ni->n", v0, _cross(v1, v2))


def tetra4_volume(xyz: jnp.ndarray) -> jnp.ndarray:
    """Unsigned tetra volume (ArcaneFemFunctions.h:60-72)."""
    return jnp.abs(tetra4_volume6_signed(xyz)) / 6.0


def tria3_gradients(xyz: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """P1 shape-function gradients for planar triangles.

    Returns (dx, dy), each (nc, 3): mirrors computeGradientX/YTria3
    (ArcaneFemFunctions.h:536-570).
    """
    x, y = xyz[..., 0], xyz[..., 1]
    a2 = tria3_area2_signed(xyz)[:, None]
    dx = jnp.stack(
        [y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1
    ) / a2
    dy = jnp.stack(
        [x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1
    ) / a2
    return dx, dy


def quad4_area2_signed(xyz: jnp.ndarray) -> jnp.ndarray:
    """The 2A shoelace determinant used by the quad4 gradient formulas
    (ArcaneFemFunctions.h:585-612)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return (
        x[:, 1] * y[:, 2]
        + x[:, 2] * y[:, 3]
        + x[:, 3] * y[:, 0]
        + x[:, 0] * y[:, 1]
    ) - (
        x[:, 2] * y[:, 1]
        + x[:, 3] * y[:, 2]
        + x[:, 0] * y[:, 3]
        + x[:, 1] * y[:, 0]
    )


def quad4_area(xyz: jnp.ndarray) -> jnp.ndarray:
    """Unsigned quad area (computeAreaQuad4, ArcaneFemFunctions.h)."""
    return 0.5 * jnp.abs(quad4_area2_signed(xyz))


def quad4_gradients(xyz: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One-point quad4 gradient vectors (ArcaneFemFunctions.h:585-640)."""
    x, y = xyz[..., 0], xyz[..., 1]
    a2 = quad4_area2_signed(xyz)[:, None]
    dx = jnp.stack(
        [
            y[:, 2] - y[:, 3],
            y[:, 3] - y[:, 0],
            y[:, 0] - y[:, 1],
            y[:, 1] - y[:, 2],
        ],
        axis=1,
    ) / a2
    dy = jnp.stack(
        [
            x[:, 3] - x[:, 2],
            x[:, 0] - x[:, 3],
            x[:, 1] - x[:, 0],
            x[:, 2] - x[:, 1],
        ],
        axis=1,
    ) / a2
    return dx, dy


def tetra4_gradients(
    xyz: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """P1 tetra shape-function gradients, (nc,4,3) -> 3×(nc,4).

    Mirrors computeGradientX/Y/ZTetra4 (ArcaneFemFunctions.h:690-816),
    including the reference's use of the *unsigned* 6V denominator.  The
    cofactors are translation-invariant, so they are formed from corners
    relative to corner 0: products of absolute coordinates would cancel
    from ~|x|·h down to ~h², losing log2(|x|/h) bits.
    """
    return tetra4_gradients_at_origin(xyz - xyz[:, :1])


def tetra4_gradients_at_origin(
    xyz: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """:func:`tetra4_gradients` of cells already translated so that their
    corners sit near the origin: callers whose cells share a corner (the
    six tets of a structured hex) translate once for all of them."""
    v6 = jnp.abs(tetra4_volume6_signed(xyz))[:, None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def comp(u, w):
        # rows of the cofactor pattern used by the reference
        c0 = u[:, 1] * (w[:, 3] - w[:, 2]) + u[:, 2] * (w[:, 1] - w[:, 3]) + u[:, 3] * (w[:, 2] - w[:, 1])
        c1 = u[:, 0] * (w[:, 2] - w[:, 3]) + u[:, 2] * (w[:, 3] - w[:, 0]) + u[:, 3] * (w[:, 0] - w[:, 2])
        c2 = u[:, 0] * (w[:, 3] - w[:, 1]) + u[:, 1] * (w[:, 0] - w[:, 3]) + u[:, 3] * (w[:, 1] - w[:, 0])
        c3 = u[:, 0] * (w[:, 1] - w[:, 2]) + u[:, 1] * (w[:, 2] - w[:, 0]) + u[:, 2] * (w[:, 0] - w[:, 1])
        return jnp.stack([c0, c1, c2, c3], axis=1)

    dx = comp(y, z) / v6
    dy = comp(z, x) / v6
    dz = comp(x, y) / v6
    return dx, dy, dz


def edge2_length(xyz: jnp.ndarray) -> jnp.ndarray:
    """(nf, 2, 3) -> (nf,) edge lengths (computeLengthEdge2)."""
    return jnp.linalg.norm(xyz[:, 1] - xyz[:, 0], axis=-1)


def edge2_normal(xyz: jnp.ndarray) -> jnp.ndarray:
    """Unit normal of boundary edges, (nf,2,3) -> (nf,2).

    Mirrors computeNormalEdge2 (ArcaneFemFunctions.h): n = (dy, -dx)/L.
    Orientation follows the stored face orientation, as in the reference
    (Arcane's boundary faces are consistently outward-oriented by Gmsh).
    """
    d = xyz[:, 1] - xyz[:, 0]
    L = jnp.linalg.norm(d[:, :2], axis=-1, keepdims=True)
    return jnp.stack([d[:, 1], -d[:, 0]], axis=1) / L[:, 0][:, None]


def tria3_normal(xyz: jnp.ndarray) -> jnp.ndarray:
    """Unit normal of boundary triangles, (nf,3,3) -> (nf,3)."""
    v = _cross(xyz[:, 1] - xyz[:, 0], xyz[:, 2] - xyz[:, 0])
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def barycenter(xyz: jnp.ndarray) -> jnp.ndarray:
    """(nc, npc, 3) -> (nc, 3)."""
    return jnp.mean(xyz, axis=1)
