"""Multi-level 2-D discrete wavelet transform with zero-extension
("mode=zero") boundary and the reference's packed coefficient layout.

JAX re-design of pfb/wavelets/wavelets.py (numba) — the
convolutions become strided `lax.conv_general_dilated` ops batched over
image rows, and the packed array is assembled with static slice updates
(all sizes are compile-time constants derived in plain Python).

Conventions copied from the reference (these ARE the spec):

- coeff_size  C = (N + F - 1) // 2        (wavelets.py:21-22)
- signal_size N = 2C - F + 2              (wavelets.py:26-27)
- analysis:   out[o] = sum_j f[j] x[2o+1-j], x zero-extended
              (wavelets.py:31-95, downsampling_convolution with step=2)
- synthesis:  out[2m]   += sum_j f[2j]   c[m+F/2-1-j]
              out[2m+1] += sum_j f[2j+1] c[m+F/2-1-j]
              (wavelets.py:99-123, upsampling_convolution_valid_sf)
- packed layout: the single (Ntoty, Ntotx) coefficient array is
  *transposed* w.r.t. the image; level-k detail blocks live at
  [ix[k][1]-2*sx[k] : ix[k][1]] with deeper levels overwriting the
  approx quadrant of shallower ones (wavelets.py:174-214,
  psi.py:48-97 for the index bookkeeping).

Images must have even nx, ny (the reference's good_size sizing loop
guarantees this; odd final signal sizes would overflow the output
buffer upstream too).
"""

from dataclasses import dataclass, field
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# float32 convolutions at DEFAULT precision may run in TF32 on a GPU
# (~3 digits); the wavelet transforms feed the exact Psi round trip
_HIGHEST = lax.Precision.HIGHEST

from pfb_tpu.ops.filters import dwt_max_level, filter_bank


def coeff_size(nsignal: int, nfilter: int) -> int:
    return (nsignal + nfilter - 1) // 2


def signal_size(ncoeff: int, nfilter: int) -> int:
    return 2 * ncoeff - nfilter + 2


@dataclass(frozen=True)
class WaveletSpec:
    """Static bookkeeping for one (basis, nx, ny, nlevel) combination —
    the functional analogue of the reference's psi_band_maker state
    (pfb/operators/psi.py:17-123)."""
    wavelet: str
    nx: int
    ny: int
    nlevel: int
    F: int
    dec_lo: tuple
    dec_hi: tuple
    rec_lo: tuple
    rec_hi: tuple
    sx: Tuple[int, ...]
    sy: Tuple[int, ...]
    spx: Tuple[int, ...]
    spy: Tuple[int, ...]
    ix: Tuple[Tuple[int, int], ...]
    iy: Tuple[Tuple[int, int], ...]
    Ntotx: int
    Ntoty: int


def make_spec(wavelet: str, nx: int, ny: int, nlevel: int) -> WaveletSpec:
    """Size/index bookkeeping identical to psi_band_maker
    (pfb/operators/psi.py:48-97)."""
    dec_lo, dec_hi, rec_lo, rec_hi = filter_bank(wavelet)
    F = len(dec_lo)
    max_level = dwt_max_level(min(nx, ny), wavelet)
    if nlevel > max_level:
        raise ValueError(
            f"The requested decomposition level {nlevel} is not possible "
            f"for {wavelet} on ({nx},{ny}); max is {max_level}")

    sx, sy, spx, spy = [], [], [], []
    Nx, Ny = nx, ny
    for _ in range(nlevel):
        Cx = coeff_size(Nx, F)
        Cy = coeff_size(Ny, F)
        sx.append(Cx)
        sy.append(Cy)
        spx.append(signal_size(Cx, F))
        spy.append(signal_size(Cy, F))
        Nx = Cx + Cx % 2
        Ny = Cy + Cy % 2
    Ntotx = sum(sx) + sx[-1]
    Ntoty = sum(sy) + sy[-1]

    ix = [None] * nlevel
    iy = [None] * nlevel
    lowx = sx[nlevel - 1]
    lowy = sy[nlevel - 1]
    ix[nlevel - 1] = (lowx, 2 * lowx)
    iy[nlevel - 1] = (lowy, 2 * lowy)
    lowx *= 2
    lowy *= 2
    for k in reversed(range(nlevel - 1)):
        ix[k] = (lowx, lowx + sx[k])
        iy[k] = (lowy, lowy + sy[k])
        lowx += sx[k]
        lowy += sy[k]

    return WaveletSpec(wavelet, nx, ny, nlevel, F,
                       tuple(dec_lo), tuple(dec_hi),
                       tuple(rec_lo), tuple(rec_hi),
                       tuple(sx), tuple(sy), tuple(spx), tuple(spy),
                       tuple(ix), tuple(iy), Ntotx, Ntoty)


def _down_conv_last(x, f):
    """Strided decimating convolution along the last axis with zero
    extension: out[..., o] = sum_j f[j] * x[..., 2o+1-j]."""
    N = x.shape[-1]
    F = len(f)
    C = coeff_size(N, F)
    k = jnp.asarray(f[::-1], x.dtype).reshape(1, 1, F)
    lead = x.shape[:-1]
    lhs = x.reshape(-1, 1, N)
    pl = F - 2
    pr = 2 * C - N
    out = lax.conv_general_dilated(
        lhs, k, window_strides=(2,), padding=[(pl, pr)],
        precision=_HIGHEST)
    return out.reshape(*lead, C)


def _up_conv_last(c, f, O):
    """Transposed (synthesis) convolution along the last axis:
    out[..., 2m]   = sum_j f[2j]   c[..., m+F/2-1-j]
    out[..., 2m+1] = sum_j f[2j+1] c[..., m+F/2-1-j]
    with output length O = 2C - F + 2."""
    C = c.shape[-1]
    F = len(f)
    Fo2 = F // 2
    fe = jnp.asarray(f[0::2][::-1], c.dtype).reshape(1, 1, Fo2)
    fo = jnp.asarray(f[1::2][::-1], c.dtype).reshape(1, 1, Fo2)
    lead = c.shape[:-1]
    lhs = c.reshape(-1, 1, C)
    # valid correlation with reversed even/odd sub-filters
    ev = lax.conv_general_dilated(lhs, fe, (1,), padding="VALID",
                                  precision=_HIGHEST)
    od = lax.conv_general_dilated(lhs, fo, (1,), padding="VALID",
                                  precision=_HIGHEST)
    out = jnp.stack([ev, od], axis=-1).reshape(-1, 1, 2 * (C - Fo2 + 1))
    return out[..., :O].reshape(*lead, O)


def _dwt_level(img, spec: WaveletSpec):
    """One analysis level: image (m, n) -> (block (2Cy, 2Cx) in the
    reference's transposed layout, approx (Cx, Cy) in image layout)
    (reference: wavelets.py:126-171)."""
    lo = _down_conv_last(img, spec.dec_lo)           # (m, Cy)
    hi = _down_conv_last(img, spec.dec_hi)
    cat = jnp.concatenate([lo, hi], axis=-1)         # (m, 2Cy)
    catT = cat.T                                     # (2Cy, m)
    lo2 = _down_conv_last(catT, spec.dec_lo)         # (2Cy, Cx)
    hi2 = _down_conv_last(catT, spec.dec_hi)
    block = jnp.concatenate([lo2, hi2], axis=-1)     # (2Cy, 2Cx) == coeffs
    Cy = lo.shape[-1]
    Cx = lo2.shape[-1]
    approx = block[:Cy, :Cx].T                       # (Cx, Cy) image layout
    return block, approx


def _idwt_level(block, spec: WaveletSpec, nxo, nyo):
    """One synthesis level: block (2Cy, 2Cx) -> image (nxo, nyo)
    (reference: wavelets.py:216-257)."""
    nay, nax = block.shape
    Cx = nax // 2
    Cy = nay // 2
    # along x: rows are y-coeff indices
    lo = block[:, :Cx]
    hi = block[:, Cx:]
    rx = _up_conv_last(lo, spec.rec_lo, nxo) + \
        _up_conv_last(hi, spec.rec_hi, nxo)          # (2Cy, nxo)
    rxT = rx.T                                       # (nxo, 2Cy)
    lo2 = rxT[:, :Cy]
    hi2 = rxT[:, Cy:]
    img = _up_conv_last(lo2, spec.rec_lo, nyo) + \
        _up_conv_last(hi2, spec.rec_hi, nyo)         # (nxo, nyo)
    return img


def dwt2d(image, spec: WaveletSpec):
    """Multi-level 2-D analysis: (nx, ny) image -> packed (Ntoty, Ntotx)
    coefficients (reference: wavelets.py:174-214)."""
    out = jnp.zeros((spec.Ntoty, spec.Ntotx), image.dtype)
    approx = image
    for i in range(spec.nlevel):
        block, approx = _dwt_level(approx, spec)
        _, highx = spec.ix[i]
        _, highy = spec.iy[i]
        lowx = highx - 2 * spec.sx[i]
        lowy = highy - 2 * spec.sy[i]
        out = lax.dynamic_update_slice(out, block, (lowy, lowx))
    return out


def idwt2d(coeffs, spec: WaveletSpec):
    """Multi-level 2-D synthesis: packed (Ntoty, Ntotx) -> (nx, ny)
    image (reference: wavelets.py:260-315)."""
    img = None
    for i in range(spec.nlevel - 1, -1, -1):
        _, highx = spec.ix[i]
        _, highy = spec.iy[i]
        lowx = highx - 2 * spec.sx[i]
        lowy = highy - 2 * spec.sy[i]
        block = lax.dynamic_slice(
            coeffs, (lowy, lowx), (2 * spec.sy[i], 2 * spec.sx[i]))
        if img is not None:
            # previous reconstruction (cropped to the level's coeff size,
            # transposed) becomes this level's approx quadrant
            appr = img[: spec.sx[i], : spec.sy[i]].T
            block = lax.dynamic_update_slice(block, appr, (0, 0))
        img = _idwt_level(block, spec, spec.spx[i], spec.spy[i])
    return img[: spec.nx, : spec.ny]
