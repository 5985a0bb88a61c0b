"""Exact-DFT measurement operator R (image -> vis) and adjoint R.H
(vis -> image), with the w-term evaluated exactly.

This is the correctness oracle for the ES-kernel wgridder (and the
production path for small problems): the reference delegates both
directions to ducc0.wgridder vis2dirty/dirty2vis
(pfb/operators/gridder.py:10,153-167,258-294); here they are chunked
cos/sin matrix products.

Conventions (matching ducc0/the reference's usage):
- pixel centres: l_i = (i - nx//2)*cellx + x0, m_j likewise
  (reference: pfb/workers/grid.py:397-398, utils/misc.py:1254-1255)
- degrid:  vis(u,v,w) = sum_lm I(l,m) exp(-2 pi i (u l + v m + w(n-1)) f/c)
- grid:    I(l,m) = sum_{r,c} wgt mask Re[ vis exp(+2 pi i (...)) ]
- divide_by_n=False everywhere by default (hardcoded in the reference,
  gridder.py:601,653): images are I/n, consumers correct for n
  (tests/test_klean.py:252-256).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

LIGHTSPEED = 299792458.0  # m/s


def _lm_grid(nx, ny, cellx, celly, x0, y0, dtype):
    l = (jnp.arange(nx, dtype=dtype) - nx // 2) * cellx + x0
    m = (jnp.arange(ny, dtype=dtype) - ny // 2) * celly + y0
    ll, mm = jnp.meshgrid(l, m, indexing="ij")
    return ll, mm


def nterm(ll, mm):
    """n - 1 = -eps/(sqrt(1-eps)+1), the numerically stable form the
    reference uses (tests/test_klean.py:256)."""
    eps = ll**2 + mm**2
    return -eps / (jnp.sqrt(1.0 - eps) + 1.0)


def _row_chunks(nrow, chunk):
    return -(-nrow // chunk)


def _two_prod(a, b):
    """Compensated product: (p, e) with a*b = p + e exactly, using the
    Dekker split (no fma needed). Recovers ~2x mantissa precision for
    the phase products in float32."""
    split = 4097.0 if a.dtype == jnp.float32 else 134217729.0
    ca = a * split
    ah = ca - (ca - a)
    al = a - ah
    cb = b * split
    bh = cb - (cb - b)
    bl = b - bh
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _frac_cycles(a, s):
    """frac(a * s) in compensated arithmetic: the phase in *cycles*
    reduced mod 1 before multiplying by 2 pi, so float32 loses no
    precision to large cycle counts (the dominant f32 error source in
    direct DFT phase evaluation)."""
    p, e = _two_prod(a, s)
    return (p - jnp.round(p)) + e


def dirty2vis_dft(uvw, freq, image, cellx, celly, x0=0.0, y0=0.0, *,
                  nx=None, ny=None, do_wterm=True, divide_by_n=False,
                  row_chunk=128, split=False):
    """R: (nx, ny) image -> (nrow, nchan) complex visibilities.
    split=True returns (real, imag) device arrays."""
    vr, vi = _dirty2vis_impl(uvw, freq, image, cellx, celly, x0=x0,
                             y0=y0, do_wterm=do_wterm,
                             divide_by_n=divide_by_n,
                             row_chunk=row_chunk)
    if split:
        return vr, vi
    return vr + 1j * vi


@partial(jax.jit, static_argnames=("do_wterm", "row_chunk",
                                   "divide_by_n", "x0", "y0"))
def _dirty2vis_impl(uvw, freq, image, cellx, celly, x0=0.0, y0=0.0, *,
                    do_wterm=True, divide_by_n=False, row_chunk=128):
    nx, ny = image.shape
    dtype = image.dtype
    ll, mm = _lm_grid(nx, ny, cellx, celly, x0, y0, dtype)
    nm1 = nterm(ll, mm)
    img = image
    if divide_by_n:
        img = img / (nm1 + 1.0)
    img_flat = img.reshape(-1)
    lmn = jnp.stack([ll.reshape(-1), mm.reshape(-1), nm1.reshape(-1)])

    nrow = uvw.shape[0]
    nchan = freq.shape[0]
    nchunk = _row_chunks(nrow, row_chunk)
    npad = nchunk * row_chunk - nrow
    uvw_p = jnp.pad(uvw, ((0, npad), (0, 0)))
    scale = (freq / LIGHTSPEED).astype(dtype)

    sx = (jnp.arange(nx, dtype=dtype) - nx // 2)
    sy = (jnp.arange(ny, dtype=dtype) - ny // 2)
    ssx = jnp.repeat(sx, ny)   # pixel-index coordinates, flattened
    ssy = jnp.tile(sy, nx)
    nm1f = lmn[2] if do_wterm else jnp.zeros_like(lmn[2])

    def chunk_fn(uvw_c):
        uvw_c = uvw_c.astype(dtype)
        au = uvw_c[:, 0:1] * scale[None, :] * cellx  # (R, nchan)
        av = uvw_c[:, 1:2] * scale[None, :] * celly
        aw = uvw_c[:, 2:3] * scale[None, :]
        # compensated phase in cycles, reduced mod 1 (critical in f32)
        cyc = _frac_cycles(au[..., None], ssx)
        cyc = cyc + _frac_cycles(av[..., None], ssy)
        cyc = cyc + aw[..., None] * nm1f
        if x0 or y0:
            cyc = cyc + _frac_cycles(au[..., None] / cellx, x0) \
                + _frac_cycles(av[..., None] / celly, y0)
        phase = (-2.0 * jnp.pi) * (cyc - jnp.round(cyc))
        # HIGHEST: a float32 product at DEFAULT precision may run in
        # TF32 on a GPU (~1e-3 relative) — the oracle must accumulate
        # at full f32
        vr = jnp.einsum("rcp,p->rc", jnp.cos(phase), img_flat,
                        precision=lax.Precision.HIGHEST)
        vi = jnp.einsum("rcp,p->rc", jnp.sin(phase), img_flat,
                        precision=lax.Precision.HIGHEST)
        return vr, vi

    vr, vi = lax.map(chunk_fn, uvw_p.reshape(nchunk, row_chunk, 3))
    return (vr.reshape(nchunk * row_chunk, nchan)[:nrow],
            vi.reshape(nchunk * row_chunk, nchan)[:nrow])


def vis2dirty_dft(uvw, freq, vis, wgt=None, mask=None, *, nx, ny,
                  cellx, celly, x0=0.0, y0=0.0, do_wterm=True,
                  divide_by_n=False, row_chunk=128):
    """R.H: (nrow, nchan) visibilities -> (nx, ny) dirty image.
    ``vis`` may be complex or a (real, imag) tuple."""
    if isinstance(vis, (tuple, list)):
        vr, vi = vis
    elif isinstance(vis, np.ndarray):
        vr = np.ascontiguousarray(vis.real)
        vi = np.ascontiguousarray(vis.imag)
    else:
        vr, vi = vis.real, vis.imag
    return _vis2dirty_impl(uvw, freq, vr, vi, wgt, mask, nx=nx, ny=ny,
                           cellx=cellx, celly=celly, x0=x0, y0=y0,
                           do_wterm=do_wterm, divide_by_n=divide_by_n,
                           row_chunk=row_chunk)


@partial(jax.jit, static_argnames=("nx", "ny", "do_wterm", "row_chunk",
                                   "divide_by_n", "x0", "y0"))
def _vis2dirty_impl(uvw, freq, vr, vi, wgt=None, mask=None, *, nx, ny,
                    cellx, celly, x0=0.0, y0=0.0, do_wterm=True,
                    divide_by_n=False, row_chunk=128):
    rdtype = jnp.finfo(jnp.result_type(vr)).dtype
    ll, mm = _lm_grid(nx, ny, cellx, celly, x0, y0, rdtype)
    nm1 = nterm(ll, mm)
    lmn = jnp.stack([ll.reshape(-1), mm.reshape(-1), nm1.reshape(-1)])
    if not do_wterm:
        lmn = lmn.at[2].set(0.0)

    nrow = uvw.shape[0]
    nchan = freq.shape[0]
    w = jnp.ones((nrow, nchan), rdtype) if wgt is None else wgt
    if mask is not None:
        w = w * mask
    nchunk = _row_chunks(nrow, row_chunk)
    npad = nchunk * row_chunk - nrow
    uvw_p = jnp.pad(uvw, ((0, npad), (0, 0)))
    wv = jnp.pad(w * vr, ((0, npad), (0, 0)))
    wi = jnp.pad(w * vi, ((0, npad), (0, 0)))
    scale = (freq / LIGHTSPEED).astype(rdtype)

    sx = (jnp.arange(nx, dtype=rdtype) - nx // 2)
    sy = (jnp.arange(ny, dtype=rdtype) - ny // 2)
    ssx = jnp.repeat(sx, ny)
    ssy = jnp.tile(sy, nx)
    nm1f = lmn[2] if do_wterm else jnp.zeros((nx * ny,), rdtype)

    def chunk_fn(carry, args):
        uvw_c, wvr, wvi = args
        uvw_c = uvw_c.astype(rdtype)
        au = uvw_c[:, 0:1] * scale[None, :] * cellx
        av = uvw_c[:, 1:2] * scale[None, :] * celly
        aw = uvw_c[:, 2:3] * scale[None, :]
        cyc = _frac_cycles(au[..., None], ssx)
        cyc = cyc + _frac_cycles(av[..., None], ssy)
        cyc = cyc + aw[..., None] * nm1f
        if x0 or y0:
            cyc = cyc + _frac_cycles(au[..., None] / cellx, x0) \
                + _frac_cycles(av[..., None] / celly, y0)
        phase = (2.0 * jnp.pi) * (cyc - jnp.round(cyc))
        # Re[vis * e^{i phase}] = vr cos - vi sin. HIGHEST precision:
        # a float32 product at DEFAULT precision may run in TF32 on a
        # GPU (~1e-3 relative error) — the oracle must
        # multiply-accumulate at full f32.
        acc = jnp.einsum("rc,rcp->p", wvr, jnp.cos(phase),
                         preferred_element_type=rdtype,
                         precision=lax.Precision.HIGHEST)
        acc -= jnp.einsum("rc,rcp->p", wvi, jnp.sin(phase),
                          preferred_element_type=rdtype,
                          precision=lax.Precision.HIGHEST)
        return carry + acc, None

    # derive the carry init from the data so it inherits any varying
    # manual axes when this runs inside shard_map (scan requires carry
    # in/out VMA types to match)
    dirty0 = jnp.zeros((nx * ny,), rdtype) + wv.reshape(-1)[0] * 0
    dirty, _ = lax.scan(chunk_fn, dirty0,
                        (uvw_p.reshape(nchunk, row_chunk, 3),
                         wv.reshape(nchunk, row_chunk, nchan),
                         wi.reshape(nchunk, row_chunk, nchan)))
    dirty = dirty.reshape(nx, ny)
    if divide_by_n:
        dirty = dirty / (nm1 + 1.0)
    return dirty
