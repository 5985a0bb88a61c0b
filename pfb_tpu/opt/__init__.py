"""Optimisation algorithms (PCG, power method, primal-dual, FISTA) —
JAX equivalents of pfb/opt/ in the reference, built on
lax.while_loop so entire solves stay on-device inside one XLA program."""
