"""Multi-chip SPMD execution: meshes, shardings and the distributed
solver steps.

The reference scales with dask.distributed futures — one
hessian_psf_slice actor per worker, scalar reductions and a
prox-ratio broadcast through the scheduler (SURVEY.md sections 2.9,
3.5). Here the same decomposition is a single SPMD program: cubes are
band-sharded (and optionally space-sharded) over a jax.sharding.Mesh,
and every reduction the reference routes through the scheduler — wsum,
MFS residual, prox band-sums, eps/rnorm scalars — becomes a psum over
the mesh.
"""

from pfb_tpu.parallel.mesh import band_sharding, make_mesh
from pfb_tpu.parallel.dist import (hessian_psf_dist, pcg_dist,
                                   power_method_dist, primal_dual_dist)
