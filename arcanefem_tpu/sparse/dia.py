"""DIA (diagonal/offset) sparse matrix — the structured-mesh fast path.

For meshes whose node graph has a fixed set of index offsets (structured
boxes, extruded grids), the BELL gather SpMV can be replaced by an offset
decomposition

    y = sum_d  band_d * shift(x, d)

which needs no column indices at all: XLA fuses the D shifted
multiply-adds into one streaming pass over the bands.  This fills the role
the CUDA atomics + CSR machinery plays in the reference's benchmark path
(femutils/BSRFormat.h:842-898) — same math, index-free layout.

``shift`` is implemented as jnp.roll: wrap-around lanes read unrelated x
values, but the corresponding band entries are zero by construction (no
cell couples those nodes), so they contribute nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bands"],
    meta_fields=["offsets"],
)
@dataclass
class DiaMatrix:
    """bands: (D, N) coefficients; offsets: static tuple of D int deltas.

    Row r couples to column r + offsets[d] with coefficient bands[d, r]
    (entries whose column falls outside [0, N) must be zero).
    """

    bands: jnp.ndarray
    offsets: tuple

    @property
    def n_dofs(self) -> int:
        return self.bands.shape[1]

    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        y = None
        for d, off in enumerate(self.offsets):
            t = self.bands[d] * (x if off == 0 else jnp.roll(x, -off))
            y = t if y is None else y + t
        return y

    def diagonal(self) -> jnp.ndarray:
        d0 = self.offsets.index(0)
        return self.bands[d0]

    def with_bands(self, bands: jnp.ndarray) -> "DiaMatrix":
        return DiaMatrix(bands=bands, offsets=self.offsets)

    def todense(self) -> np.ndarray:
        """Dense conversion for tests/small systems."""
        n = self.n_dofs
        out = np.zeros((n, n), np.asarray(self.bands).dtype)
        b = np.asarray(self.bands)
        for d, off in enumerate(self.offsets):
            rows = np.arange(n)
            cols = rows + off
            m = (cols >= 0) & (cols < n)
            out[rows[m], cols[m]] = b[d, m]
        return out
