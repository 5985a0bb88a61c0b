"""Image-space PSF Hessian approximation.

The reference computes ``F.H PSFHAT F`` with padded real FFTs in
preallocated buffers (pfb/operators/psf.py, pfb/operators/hessian.py:129-158).
Here the whole Hessian matvec is one fused jitted function; XLA fuses the
pad/multiply/crop elementwise work into the FFTs so no manual buffer
management is needed.
"""

from functools import partial

import jax
import jax.numpy as jnp

from pfb_tpu.ops.fft import psf_convolve_cube, psf_convolve_slice


def hessian_psf_slice(x, psfhat, beam=None, lastsize=None, sigmainv=0.0,
                      wsum=None):
    """Tikhonov-regularised PSF Hessian for one band
    (reference: pfb/operators/hessian.py:129-158).

    Computes ``beam * (PSF conv (beam * x)) / wsum + sigmainv * x``.
    """
    if lastsize is None:
        lastsize = psfhat.shape[-2]
    xin = x * beam if beam is not None else x
    xout = psf_convolve_slice(xin, psfhat, lastsize)
    if beam is not None:
        xout = xout * beam
    if wsum is not None:
        xout = xout / wsum
    return xout + x * sigmainv


def hessian_psf_cube(x, psfhat, beam=None, lastsize=None, sigmainv=0.0,
                     wsum=None, band_chunk=None):
    """Cube (nband, nx, ny) variant
    (reference: pfb/operators/hessian.py:254-281)."""
    if lastsize is None:
        lastsize = psfhat.shape[-2]
    xin = x * beam if beam is not None else x
    xout = psf_convolve_cube(xin, psfhat, lastsize, band_chunk=band_chunk)
    if beam is not None:
        xout = xout * beam
    if wsum is not None:
        xout = xout / wsum
    return xout + x * sigmainv


@partial(jax.jit, static_argnames=("lastsize", "band_chunk"))
def _hess_cube_jit(x, psfhat, beam, lastsize, sigmainv, wsum, band_chunk):
    return hessian_psf_cube(x, psfhat, beam=beam, lastsize=lastsize,
                            sigmainv=sigmainv, wsum=wsum,
                            band_chunk=band_chunk)


def make_psf_convolve(psfhat, lastsize, beam=None, sigmainv=0.0, wsum=None,
                      band_chunk=None):
    """Return the cube Hessian matvec, the unit used by the
    deconvolvers (reference: pfb/workers/spotless.py:182-183).

    ``matvec(x)`` is a jitted call with the operator arrays passed as
    jit *arguments*, never captured as trace-time constants: a
    captured array is baked into the executable, which at 4096^2 x 8
    means gigabytes of PSFHAT.

    Fused-solver hooks: ``matvec.apply(x, consts)`` is the same
    operator as a pure function of ``consts = matvec.consts`` (PSFHAT
    and the beam), for solvers that jit a whole while-loop around it
    (:func:`pfb_tpu.opt.pcg.make_pcg_bands_fused`,
    :func:`pfb_tpu.opt.primal_dual.make_primal_dual_fused`,
    :func:`pfb_tpu.opt.power_method.make_power_method_fused`), so the
    transfer function enters that program as an argument too.
    """
    real_dtype = jnp.finfo(psfhat.dtype).dtype  # dtype only — no .real
    sigmainv = jnp.asarray(sigmainv, real_dtype)
    wsum = None if wsum is None else jnp.asarray(wsum)

    def matvec(x):
        return _hess_cube_jit(x, psfhat, beam, lastsize, sigmainv, wsum,
                              band_chunk)

    def apply(x, consts):
        return hessian_psf_cube(x, consts["psfhat"], beam=consts["beam"],
                                lastsize=lastsize, sigmainv=sigmainv,
                                wsum=wsum, band_chunk=band_chunk)

    matvec.apply = apply
    matvec.consts = {"psfhat": psfhat, "beam": beam}
    return matvec
