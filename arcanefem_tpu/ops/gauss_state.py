"""Persistent per-Gauss-point state — the GaussDoFsOnCells role
(reference femutils/GaussDoFsOnCells.h:63-69: per-Gauss-point weight, shape
values, shape derivatives, Jacobian det stored in DoF variables;
modules/passmo/ElastodynamicModule.cc:188-253 precomputes them once per
cell and reuses them every time step).

Device-side shape: instead of DoF-variables on a Gauss "cell family", the
state is a pytree of batched device arrays per cell bucket —
(ng, nc, npc, dim) gradients and (ng, nc) w·|detJ| — built ONCE from the
coordinates and closed over by every assembly/recovery jit.  Matrices and
Gauss-point fields (strain/stress recovery) are then pure contractions of
the stored state, with no geometry recomputation inside the time loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import quadrature as Q


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["N", "grads", "wdet"],
    meta_fields=["cell_type", "ninteg", "dim"],
)
@dataclass
class CellGaussState:
    """One cell bucket's persistent Gauss data (device arrays).

    N is shared by every cell of the bucket; grads/wdet are batched
    (ng, nc, npc, dim) / (ng, nc).
    """

    cell_type: str
    N: jnp.ndarray  # (ng, npc) shape values at Gauss points
    grads: jnp.ndarray  # (ng, nc, npc, dim) physical shape gradients
    wdet: jnp.ndarray  # (ng, nc) w_g * |det J|
    ninteg: int
    dim: int

    @property
    def n_gauss(self) -> int:
        return self.N.shape[0]


class GaussState:
    """dict-of-buckets persistent Gauss state for a whole mesh."""

    def __init__(self, buckets: dict[str, CellGaussState], ninteg: int,
                 dim: int):
        self.buckets = buckets
        self.ninteg = ninteg
        self.dim = dim

    @staticmethod
    def build(mesh, coords: jnp.ndarray, ninteg: int = 2,
              dim: int | None = None) -> "GaussState":
        """Precompute grads/wdet for every cell bucket (once per mesh)."""
        dim = dim if dim is not None else mesh.dim
        buckets = {}
        for ct, conn in mesh.cells.items():
            xyz = coords[jnp.asarray(np.asarray(conn))]
            N, grads, wdet = Q.iso_geometry(ct, xyz, dim, ninteg)
            buckets[ct] = CellGaussState(
                cell_type=ct,
                N=jnp.asarray(np.asarray(N, coords.dtype)),
                grads=grads, wdet=wdet,
                ninteg=ninteg, dim=dim,
            )
        return GaussState(buckets, ninteg, dim)

    # -- assembly from stored state (no geometry recomputation) ------------

    def stiffness_blocks(self, ct: str, lam, mu) -> jnp.ndarray:
        """Elasticity blocks from the stored gradients; same contraction
        as quadrature.stiffness_blocks_iso but on persistent state."""
        st = self.buckets[ct]
        grads, wdet = st.grads, st.wdet
        lamc = jnp.asarray(lam) * wdet  # (g, c)
        muc = jnp.asarray(mu) * wdet
        t_div = jnp.einsum("gc,gcia,gcjb->cijab", lamc, grads, grads)
        t_eps1 = jnp.einsum("gc,gcib,gcja->cijab", muc, grads, grads)
        dot = jnp.einsum("gc,gcik,gcjk->gcij", muc, grads, grads)
        eye = jnp.eye(st.dim, dtype=grads.dtype)
        t_eps2 = jnp.einsum("gcij,ab->cijab", dot, eye)
        return t_div + t_eps1 + t_eps2

    def mass_blocks(self, ct: str, rho) -> jnp.ndarray:
        st = self.buckets[ct]
        rhoc = jnp.asarray(rho) * st.wdet
        m = jnp.einsum("gc,gi,gj->cij", rhoc, st.N, st.N)
        eye = jnp.eye(st.dim, dtype=st.wdet.dtype)
        return m[:, :, :, None, None] * eye[None, None, None]

    # -- per-Gauss-point field recovery -------------------------------------

    def strain(self, ct: str, conn: np.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """Small-strain tensor at every Gauss point: (ng, nc, d, d).

        u: (n_nodes*d,) displacement vector.  The reference reads back
        per-Gauss stress/strain through the GaussDoFsOnCells variables
        (ElastodynamicModule.cc Gauss loops); here it is one einsum over
        the stored gradients.
        """
        st = self.buckets[ct]
        d = st.dim
        ue = u.reshape(-1, d)[jnp.asarray(np.asarray(conn))]  # (nc, npc, d)
        gradu = jnp.einsum("gcnr,cnd->gcdr", st.grads, ue)  # (g,nc,d,d)
        return 0.5 * (gradu + jnp.swapaxes(gradu, -1, -2))

    def stress(self, ct: str, conn: np.ndarray, u: jnp.ndarray,
               lam, mu) -> jnp.ndarray:
        """Linear-elastic Cauchy stress at every Gauss point."""
        eps = self.strain(ct, conn, u)
        d = self.buckets[ct].dim
        tr = jnp.trace(eps, axis1=-2, axis2=-1)
        eye = jnp.eye(d, dtype=eps.dtype)
        lamg = jnp.asarray(lam)
        mug = jnp.asarray(mu)
        if lamg.ndim:  # per-cell -> broadcast over (g, c)
            lamg = lamg[None, :, None, None]
            mug = mug[None, :, None, None]
        return lamg * tr[..., None, None] * eye + 2.0 * mug * eps
