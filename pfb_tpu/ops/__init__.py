"""Linear operators (measurement operator, PSF Hessian, FFTs, wavelets,
prox, weighting) — the JAX equivalents of pfb/operators/,
pfb/wavelets/ and pfb/prox/ in the reference."""
