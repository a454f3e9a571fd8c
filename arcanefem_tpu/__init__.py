"""arcanefem_tpu — JAX finite-element framework for the GPU.

A ground-up JAX/XLA rebuild of the capabilities of ArcaneFEM
(reference: toutane/arcanefem): unstructured-mesh FEM solvers for
Poisson/Laplace/Fourier/heat/acoustics/electrostatics/aerodynamics/
bilaplacian/elasticity/elastodynamics/soildynamics/passmo, with
sort/segment-sum sparse assembly, on-device Krylov solvers, and
mesh-sharded multi-chip execution via jax.sharding.
"""

from .mesh import Mesh, read_msh

__version__ = "0.1.0"

__all__ = ["Mesh", "read_msh", "__version__"]
