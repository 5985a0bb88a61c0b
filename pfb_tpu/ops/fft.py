"""FFT helpers.

JAX replacement for the reference's ducc0.fft usage
(reference: pfb/operators/fft.py, pfb/operators/psf.py:22-27).

Conventions (identical to the reference):
- ``psfhat = rfft2(ifftshift(psf))`` — the PSF peak is moved to the grid
  origin before the forward transform (reference:
  pfb/operators/gridder.py:712-714, inorm=0 i.e. unnormalised forward).
- The inverse transform is normalised by 1/N (reference c2r inorm=2).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def good_size(n: int, even: bool = False) -> int:
    """Smallest 5-smooth number >= n (optionally even).

    Replacement for ducc0.fft.good_size: XLA's FFT is efficient for sizes
    whose prime factors are 2, 3 and 5.
    """
    if n <= 2:
        return max(n, 1) if not even else 2

    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while True:
        if smooth(m) and (not even or m % 2 == 0):
            return m
        m += 1


def good_even_size(n: int) -> int:
    """Smallest even 5-smooth number >= n.

    Mirrors the reference's image/PSF sizing loop
    (pfb/workers/grid.py:259-262: ``while npix % 2: npix += 1;
    npix = good_size(npix)``).
    """
    m = good_size(n)
    while m % 2:
        m = good_size(m + 1)
    return m


def fft2d(x, axes=(-2, -1)):
    """rfft2 of ifftshift(x) — matches reference _fft2d_impl
    (pfb/operators/fft.py:7-9, forward unnormalised)."""
    return jnp.fft.rfft2(jnp.fft.ifftshift(x, axes=axes), axes=axes)


def fft_cube(x):
    """Per-band rfft2 of ifftshift — reference _fft_cube_impl
    (pfb/operators/fft.py:26-33)."""
    return fft2d(x, axes=(-2, -1))


@partial(jax.jit, static_argnames=("nx", "ny", "lastsize", "band_chunk"))
def _psf_convolve_impl(x, psfhat, nx, ny, lastsize, band_chunk=None):
    nx_psf = psfhat.shape[-2]

    def one(args):
        xb, ph = args
        xpad = jnp.pad(xb, [(0, 0)] * (xb.ndim - 2)
                       + [(0, nx_psf - nx), (0, lastsize - ny)])
        xhat = jnp.fft.rfft2(xpad, axes=(-2, -1))
        xhat = xhat * ph
        out = jnp.fft.irfft2(xhat, s=(nx_psf, lastsize), axes=(-2, -1))
        return out[..., :nx, :ny]

    if band_chunk is None or x.ndim == 2 or x.shape[0] <= band_chunk:
        return one((x, psfhat))
    # Large cubes: FFT workspace for the full padded cube can exceed
    # device memory (psf_oversize=2 quadruples the grid — the
    # reference's memory wall, spotless.py:175-183). Process the band
    # axis in chunks with lax.map.
    nband = x.shape[0]
    nchunk = -(-nband // band_chunk)
    npad = nchunk * band_chunk - nband
    xr = jnp.pad(x, [(0, npad), (0, 0), (0, 0)])
    phr = jnp.pad(psfhat, [(0, npad), (0, 0), (0, 0)])
    xr = xr.reshape(nchunk, band_chunk, nx, ny)
    phr = phr.reshape(nchunk, band_chunk, *psfhat.shape[-2:])
    out = jax.lax.map(one, (xr, phr))
    return out.reshape(nchunk * band_chunk, nx, ny)[:nband]


def psf_convolve_slice(x, psfhat, lastsize):
    """Zero-pad -> rfft2 -> * psfhat -> irfft2 -> unpad for a single 2D
    image (reference: pfb/operators/psf.py:11-29).

    ``psfhat`` must be ``rfft2(ifftshift(psf))`` for a PSF of shape
    (nx_psf, lastsize).
    """
    nx, ny = x.shape[-2:]
    return _psf_convolve_impl(x, psfhat, nx, ny, lastsize)


def psf_convolve_cube(x, psfhat, lastsize, band_chunk=None):
    """Batched PSF convolution over the band axis
    (reference: pfb/operators/psf.py:32-56). x is (nband, nx, ny),
    psfhat is (nband, nx_psf, lastsize//2+1).

    ``band_chunk`` bounds FFT workspace by mapping over chunks of
    bands."""
    nx, ny = x.shape[-2:]
    return _psf_convolve_impl(x, psfhat, nx, ny, lastsize,
                              band_chunk=band_chunk)


@partial(jax.jit, static_argnames=("band_chunk",))
def make_psfhat(psf, band_chunk=None):
    """PSFHAT from a PSF image: rfft2(ifftshift(psf)) — reference
    pfb/operators/gridder.py:712-714.

    ``band_chunk`` bounds FFT workspace for big PSF cubes (same reasoning
    as :func:`psf_convolve_cube`)."""
    def one(p):
        return jnp.fft.rfft2(jnp.fft.ifftshift(p, axes=(-2, -1)),
                             axes=(-2, -1))

    if band_chunk is None or psf.ndim == 2 or psf.shape[0] <= band_chunk:
        return one(psf)
    nband = psf.shape[0]
    nchunk = -(-nband // band_chunk)
    npad = nchunk * band_chunk - nband
    pr = jnp.pad(psf, [(0, npad), (0, 0), (0, 0)])
    pr = pr.reshape(nchunk, band_chunk, *psf.shape[-2:])
    out = jax.lax.map(one, pr)
    return out.reshape(nchunk * band_chunk, *out.shape[-2:])[:nband]


def get_padding_info(nx, ny, pfrac):
    """Padding bookkeeping for FFT convolutions
    (reference: pfb/utils/misc.py:170-183)."""
    npad_x = int(pfrac * nx)
    nfft = good_size(nx + npad_x, True)
    npad_xl = (nfft - nx) // 2
    npad_xr = nfft - nx - npad_xl
    npad_y = int(pfrac * ny)
    nfft = good_size(ny + npad_y, True)
    npad_yl = (nfft - ny) // 2
    npad_yr = nfft - ny - npad_yl
    padding = ((0, 0), (npad_xl, npad_xr), (npad_yl, npad_yr))
    unpad_x = slice(npad_xl, -npad_xr) if npad_xr else slice(npad_xl, None)
    unpad_y = slice(npad_yl, -npad_yr) if npad_yr else slice(npad_yl, None)
    return padding, unpad_x, unpad_y
