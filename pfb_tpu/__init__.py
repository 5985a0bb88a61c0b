"""pfb_tpu — radio-interferometric imaging framework in JAX.

A brand-new JAX/XLA implementation of the pre-conditioned
forward-backward (PFB) imaging stack with the capabilities of
ratt-ru/pfb-clean (pfb-imaging, reference at /root/reference):

- measurement operator R (degridding) and adjoint R.H (gridding), both as
  an exact-DFT oracle and an ES-kernel w-stacking gridder
  (reference: pfb/operators/gridder.py via ducc0.wgridder)
- FFT-based PSF Hessian convolution (reference: pfb/operators/psf.py)
- PCG / power method / FISTA / primal-dual solvers (reference: pfb/opt/)
- SARA wavelet dictionary with prox_21/prox_21m (reference:
  pfb/operators/psi.py, pfb/wavelets/wavelets.py, pfb/prox/)
- Hogbom and Clark CLEAN minor cycles (reference: pfb/deconv/)
- the worker pipeline init -> grid -> klean/spotless -> model2comps ->
  degrid -> restore (reference: pfb/workers/)

Design: no dask graphs, no numba; everything on the compute path is a pure
jitted function over (nband, nx, ny) cubes. Multi-chip runs shard the band
axis (and optionally the image plane) over a jax.sharding.Mesh with psum
reductions in place of dask.distributed futures (reference parallelism
inventory: SURVEY.md section 2.9).
"""

__version__ = "0.1.0"

from pfb_tpu.config import set_precision, default_real_dtype
