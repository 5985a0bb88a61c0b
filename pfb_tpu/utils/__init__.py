"""Host-side utilities: data stores, FITS I/O, simulation, beams,
model fitting — the JAX equivalents of pfb/utils/ in the
reference (dask-ms/casacore/astropy-free)."""
