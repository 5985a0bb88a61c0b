"""Deconvolution minor cycles (Hogbom, Clark) — JAX equivalents
of pfb/deconv/ in the reference, restructured as lax.while_loop programs
with dynamic-slice PSF subtraction."""
