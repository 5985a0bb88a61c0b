"""Clark CLEAN: active-set minor cycle with periodic exact residual
updates via cube PSF convolution.

JAX redesign of pfb/deconv/clark.py:12-177. The reference
extracts the active set into index lists and runs a numba subminor loop;
here the active set is a boolean image mask (static shapes for XLA) and
the subminor peak-find/subtract runs as a lax.while_loop over the full
(masked) residual with dynamic-slice PSF subtraction. Subtraction is
masked to the active set — inactive pixels are refreshed by the outer
cube convolution exactly as in the reference.

Semantics copied from the reference:
- inputs are normalised by wsum (dirty/PSF in Jy/beam over the MFS sum);
  wsums are the per-band weights with sum(wsums) == 1 (clark.py:96-106)
- outer tol = max(pf * IRmax, threshold); subminor threshold
  subth = subpf * IRmax (clark.py:123-129)
- stall detection: upstream intends to stop after 5 low-progress outer
  iterations but its counter never increments (`stall_count +=
  stall_count`, clark.py:154). Here the counter counts *consecutive*
  outer iterations with relative peak change < 1e-4 and resets on
  progress — outer iterations complete a full subminor pass, so genuine
  lack of progress there is meaningful.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from pfb_tpu.ops.fft import psf_convolve_cube


def _peak(IR, mask=None):
    ny = IR.shape[-1]
    IRsearch = jnp.sum(IR, axis=0) ** 2
    if mask is not None:
        IRsearch = jnp.where(mask, IRsearch, 0.0)
    pq = jnp.argmax(IRsearch)
    p = pq // ny
    q = pq - p * ny
    return p, q, jnp.sqrt(IRsearch[p, q])


@partial(jax.jit, static_argnames=("submaxit",))
def _subminor(IR, PSF, mask, model, wsums, gamma, subth, submaxit):
    """Active-set peak-find/subtract loop
    (reference: clark.py:28-79, subminor)."""
    nband, nx, ny = IR.shape
    nx0 = PSF.shape[-2] // 2
    ny0 = PSF.shape[-1] // 2
    fsel = wsums > 0
    safe_wsums = jnp.where(fsel, wsums, 1.0)

    p0, q0, Amax0 = _peak(IR, mask)

    def cond(state):
        IR, model, p, q, Amax, k = state
        return (Amax > subth) & (k < submaxit)

    def body(state):
        IR, model, p, q, Amax, k = state
        # the model gains gamma * xhat / wsums per band; its image is
        # that flux times the band's PSF, whose peak is wsums
        dx = jnp.where(fsel, gamma * IR[:, p, q] / safe_wsums, 0.0)
        model = model.at[:, p, q].add(dx)
        psf_slice = lax.dynamic_slice(
            PSF, (0, nx0 - p, ny0 - q), (nband, nx, ny))
        IR = IR - jnp.where(mask[None], dx[:, None, None] * psf_slice,
                            0.0)
        pn, qn, Amax_n = _peak(IR, mask)
        return IR, model, pn, qn, Amax_n, k + 1

    state0 = (IR, model, p0, q0, Amax0, jnp.asarray(0, jnp.int32))
    IR, model, p, q, Amax, k = lax.while_loop(cond, body, state0)
    return model


@partial(jax.jit, static_argnames=("maxit", "submaxit", "band_chunk"))
def clark(ID, PSF, PSFHAT, wsums, threshold=0.0, gamma=0.05, pf=0.05,
          maxit=50, subpf=0.5, submaxit=1000, band_chunk=None):
    """Returns (model, residual, status). status 0 on convergence, 1 on
    maxit/stall (reference: clark.py:81-177)."""
    nband, nx, ny = ID.shape
    ny_psf = PSF.shape[-1]

    model = jnp.zeros_like(ID)
    IR = ID
    p, q, IRmax = _peak(IR)
    tol = jnp.maximum(pf * IRmax, jnp.asarray(threshold, ID.dtype))

    def outer_cond(state):
        model, IR, IRmax, k, stall = state
        return (IRmax > tol) & (k < maxit) & (stall < 5)

    def outer_body(state):
        model, IR, IRmax, k, stall = state
        subth = subpf * IRmax
        IRsearch = jnp.sum(IR, axis=0) ** 2
        mask = IRsearch > subth**2
        model = _subminor(IR, PSF, mask, model, wsums, gamma, subth,
                          submaxit)
        conv = psf_convolve_cube(model, PSFHAT, ny_psf,
                                 band_chunk=band_chunk)
        IR = ID - conv
        _, _, IRmax_n = _peak(IR)
        stalled = jnp.abs(IRmax - IRmax_n) / jnp.abs(IRmax) < 1e-4
        stall = jnp.where(stalled, stall + 1, 0)
        return model, IR, IRmax_n, k + 1, stall

    state0 = (model, IR, IRmax, jnp.asarray(0, jnp.int32),
              jnp.asarray(0, jnp.int32))
    model, IR, IRmax, k, stall = lax.while_loop(outer_cond, outer_body,
                                                state0)
    status = ((k >= maxit) | (stall >= 5)).astype(jnp.int32)
    return model, IR, status
