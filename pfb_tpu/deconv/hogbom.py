"""Hogbom CLEAN minor cycle.

JAX redesign of pfb/deconv/hogbom.py:8-74: the numpy/numexpr
peak-find/subtract loop becomes one lax.while_loop with a
dynamic-slice PSF subtraction (the reference itself sketches this
design in its commented-out hogbom_jax, deconv/hogbom.py:77-117).

Semantics copied from the reference:
- search image is the squared MFS residual (sum over bands)^2
- per-band flux with wsums = max(PSF, axis=(1,2)) normalisation; bands
  with wsums == 0 are skipped
- tol = max(pf * initial_peak, threshold)
- stall detection: the reference intends to stop after 5 low-progress
  iterations but its counter never increments (`stall_count +=
  stall_count` starting from 0, hogbom.py:52), so stalling is
  effectively disabled upstream. A literal fix (+= 1 at 5e-3 relative
  change) aborts healthy CLEANs: with several comparable sources the
  *global* peak moves by far less than the loop gain each iteration.
  Here the counter counts *consecutive* iterations with relative peak
  change < 1e-7 (a true no-progress guard against numerically stuck
  states) and resets on progress.

Requires PSF of shape (nband, >=2*nx, >=2*ny) so the dynamic slice is
always in range.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("maxit",))
def hogbom(ID, PSF, threshold=0.0, gamma=0.1, pf=0.1, maxit=10000):
    """Returns (model, residual, status) with status 0 on clean
    convergence, 1 on maxit/stall (reference return convention)."""
    nband, nx, ny = ID.shape
    _, nx_psf, ny_psf = PSF.shape
    nx0, ny0 = nx_psf // 2, ny_psf // 2
    dt = ID.dtype

    wsums = jnp.amax(PSF, axis=(1, 2))
    fsel = wsums > 0
    safe_wsums = jnp.where(fsel, wsums, 1.0)

    def peak(IR):
        IRsearch = jnp.sum(IR, axis=0) ** 2
        pq = jnp.argmax(IRsearch)
        p = pq // ny
        q = pq - p * ny
        return p, q, jnp.sqrt(IRsearch[p, q])

    IR0 = ID
    p0, q0, IRmax0 = peak(IR0)
    tol = jnp.maximum(pf * IRmax0, threshold)

    def cond(state):
        x, IR, p, q, IRmax, k, stall = state
        return (IRmax > tol) & (k < maxit) & (stall < 5)

    def body(state):
        x, IR, p, q, IRmax, k, stall = state
        xhat = jnp.where(fsel, IR[:, p, q] / safe_wsums, 0.0)
        x = x.at[:, p, q].add(gamma * xhat)
        psf_slice = lax.dynamic_slice(
            PSF, (0, nx0 - p, ny0 - q), (nband, nx, ny))
        IR = IR - gamma * xhat[:, None, None] * psf_slice
        pn, qn, IRmax_n = peak(IR)
        stalled = jnp.abs(IRmax - IRmax_n) / jnp.abs(IRmax) < 1e-7
        stall = jnp.where(stalled, stall + 1, 0)
        return x, IR, pn, qn, IRmax_n, k + 1, stall

    x0 = jnp.zeros_like(ID)
    state0 = (x0, IR0, p0, q0, IRmax0, jnp.asarray(0, jnp.int32),
              jnp.asarray(0, jnp.int32))
    x, IR, p, q, IRmax, k, stall = lax.while_loop(cond, body, state0)
    status = ((k >= maxit) | (stall >= 5)).astype(jnp.int32)
    return x, IR, status
