"""uv-cell sampling density and Briggs/robust imaging weights.

JAX equivalents of the reference's numba kernels
(pfb/utils/weighting.py:43-171): the per-row scatter/gather loops become
one vectorised XLA scatter-add over all (row, chan, stencil) triples and
a vectorised gather.

Grid convention copied exactly from the reference (weighting.py:48-55):
    u_cell = 1/(nx*cellx);  umax = |-1/(2 cellx) - u_cell/2|
    ug = (u*f/c + umax)/u_cell
ES-kernel stencil k=6, beta=2.3 (weighting.py:46,93-97,105-107).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pfb_tpu.ops.dft import LIGHTSPEED


def _es_kernel(x, beta, k):
    """exp(beta*k*(sqrt((1-x)(1+x)) - 1)) on |x|<=1, 0 outside
    (reference: weighting.py:105-107)."""
    arg = jnp.maximum((1.0 - x) * (1.0 + x), 0.0)
    val = jnp.exp(beta * k * (jnp.sqrt(arg) - 1.0))
    return jnp.where(jnp.abs(x) <= 1.0, val, 0.0)


@partial(jax.jit, static_argnames=("nx", "ny", "k"))
def compute_counts(uvw, freq, mask, nx, ny, cellx, celly, k=6):
    """Grid the sampling density onto the uv grid with the ES kernel
    (k=6) or nearest-neighbour (k=0)
    (reference: pfb/utils/weighting.py:43-103)."""
    dtype = jnp.result_type(uvw.dtype, jnp.float32)
    u_cell = 1.0 / (nx * cellx)
    umax = jnp.abs(-1.0 / cellx / 2.0 - u_cell / 2.0)
    v_cell = 1.0 / (ny * celly)
    vmax = jnp.abs(-1.0 / celly / 2.0 - v_cell / 2.0)

    normfreq = freq / LIGHTSPEED
    ug = (uvw[:, 0:1] * normfreq[None, :] + umax) / u_cell  # (row, chan)
    vg = (uvw[:, 1:2] * normfreq[None, :] + vmax) / v_cell
    m = mask.astype(dtype)

    counts = jnp.zeros((nx, ny), dtype)
    if k:
        ko2 = k // 2
        u_idx = jnp.round(ug).astype(jnp.int32)
        v_idx = jnp.round(vg).astype(jnp.int32)
        offs = jnp.arange(-ko2, ko2)
        # x offsets: (row, chan, k)
        x_idx = u_idx[..., None] + offs
        xval = _es_kernel((x_idx - ug[..., None] + 0.5) / ko2, 2.3, k)
        y_idx = v_idx[..., None] + offs
        yval = _es_kernel((y_idx - vg[..., None] + 0.5) / ko2, 2.3, k)
        # outer product over the stencil: (row, chan, k, k)
        vals = (m[..., None, None] * xval[..., :, None] *
                yval[..., None, :])
        xi = jnp.broadcast_to(x_idx[..., :, None], vals.shape)
        yi = jnp.broadcast_to(y_idx[..., None, :], vals.shape)
        counts = counts.at[xi.reshape(-1), yi.reshape(-1)].add(
            vals.reshape(-1), mode="drop")
        # Production weighting runs the HOST path below (the
        # reference's compute_counts is a CPU numba kernel too); this
        # device path serves small / device-resident callers.
    else:
        u_idx = jnp.floor(ug).astype(jnp.int32)
        v_idx = jnp.floor(vg).astype(jnp.int32)
        counts = counts.at[u_idx.reshape(-1), v_idx.reshape(-1)].add(
            m.reshape(-1), mode="drop")
    return counts


def compute_counts_host(uvw, freq, mask, nx, ny, cellx, celly, k=6,
                        row_chunk=65536):
    """Numpy twin of :func:`compute_counts` for the grid/fastim
    workers' once-per-run weighting pass: a chunked flat-index
    np.bincount (C-speed) over the (row, chan, k, k) stencil values.
    The reference's counts kernel is likewise CPU code
    (pfb/utils/weighting.py:43-103, numba prange). The native C++
    kernel (pfb_tpu/native) runs when a toolchain is available.
    Identical per-tap drop semantics: out-of-grid taps are
    discarded."""
    uvw = np.asarray(uvw)
    freq = np.asarray(freq)
    mask = np.asarray(mask)
    from pfb_tpu.native import pg_counts_native
    nat = pg_counts_native(uvw, freq, mask, nx, ny, cellx, celly, k=k)
    if nat is not None:
        return nat
    dtype = np.float64
    u_cell = 1.0 / (nx * cellx)
    umax = np.abs(-1.0 / cellx / 2.0 - u_cell / 2.0)
    v_cell = 1.0 / (ny * celly)
    vmax = np.abs(-1.0 / celly / 2.0 - v_cell / 2.0)
    normfreq = freq / LIGHTSPEED
    counts = np.zeros(nx * ny, dtype)
    ko2 = k // 2
    offs = np.arange(-ko2, ko2)

    def es(x):
        arg = np.maximum((1.0 - x) * (1.0 + x), 0.0)
        return np.where(np.abs(x) <= 1.0,
                        np.exp(2.3 * k * (np.sqrt(arg) - 1.0)), 0.0)

    nrow = uvw.shape[0]
    for r0 in range(0, nrow, row_chunk):
        sl = slice(r0, min(r0 + row_chunk, nrow))
        ug = (uvw[sl, 0:1] * normfreq[None, :] + umax) / u_cell
        vg = (uvw[sl, 1:2] * normfreq[None, :] + vmax) / v_cell
        m = mask[sl].astype(dtype)
        if k:
            u_idx = np.round(ug).astype(np.int64)
            v_idx = np.round(vg).astype(np.int64)
            x_idx = u_idx[..., None] + offs
            xval = es((x_idx - ug[..., None] + 0.5) / ko2)
            y_idx = v_idx[..., None] + offs
            yval = es((y_idx - vg[..., None] + 0.5) / ko2)
            vals = (m[..., None, None] * xval[..., :, None]
                    * yval[..., None, :])
            xi = np.broadcast_to(x_idx[..., :, None], vals.shape)
            yi = np.broadcast_to(y_idx[..., None, :], vals.shape)
            ok = ((xi >= 0) & (xi < nx) & (yi >= 0)
                  & (yi < ny)).ravel()
            flat = (xi.ravel()[ok] * ny + yi.ravel()[ok])
            counts += np.bincount(flat, weights=vals.ravel()[ok],
                                  minlength=nx * ny)
        else:
            u_idx = np.floor(ug).astype(np.int64)
            v_idx = np.floor(vg).astype(np.int64)
            ok = ((u_idx >= 0) & (u_idx < nx) & (v_idx >= 0)
                  & (v_idx < ny)).ravel()
            flat = (u_idx.ravel()[ok] * ny + v_idx.ravel()[ok])
            counts += np.bincount(flat, weights=m.ravel()[ok],
                                  minlength=nx * ny)
    return counts.reshape(nx, ny)


@partial(jax.jit, static_argnames=("nx", "ny"))
def counts_to_weights(counts, uvw, freq, nx, ny, cellx, celly, robust):
    """Counts -> per-visibility imaging weights. robust > -2 applies
    Briggs weighting 1/(1 + counts*ssq) with
    ssq = (5*10^-robust)^2 / ((counts^2).sum()/counts.sum())
    (reference: pfb/utils/weighting.py:130-171)."""
    dtype = counts.dtype
    u_cell = 1.0 / (nx * cellx)
    umax = jnp.abs(-1.0 / cellx / 2.0 - u_cell / 2.0)
    v_cell = 1.0 / (ny * celly)
    vmax = jnp.abs(-1.0 / celly / 2.0 - v_cell / 2.0)

    def briggs(c):
        numsqrt = 5.0 * 10.0 ** (-robust)
        avgW = jnp.sum(c**2) / jnp.sum(c)
        ssq = numsqrt * numsqrt / avgW
        return 1.0 + c * ssq

    counts_mod = jax.lax.cond(jnp.asarray(robust) > -2.0, briggs,
                              lambda c: c, counts)

    normfreq = freq / LIGHTSPEED
    u_idx = jnp.floor(
        (uvw[:, 0:1] * normfreq[None, :] + umax) / u_cell).astype(jnp.int32)
    v_idx = jnp.floor(
        (uvw[:, 1:2] * normfreq[None, :] + vmax) / v_cell).astype(jnp.int32)
    c = counts_mod[jnp.clip(u_idx, 0, nx - 1), jnp.clip(v_idx, 0, ny - 1)]
    w = jnp.where(c != 0, 1.0 / jnp.where(c == 0, 1.0, c), 0.0)
    return jnp.where(jnp.any(counts != 0), w, jnp.zeros_like(w)).astype(dtype)


def filter_extreme_counts(counts, level=10.0, nbox=None):
    """Clamp near-empty uv cells to avoid upweighting them
    (reference: pfb/utils/weighting.py:186-215). Host-side numpy
    (needs a data-dependent median over nonzeros).

    nbox=None (default): global median clamp — occupied cells below
    median/level are raised to it (the reference's live behaviour).
    nbox=N: the reference's dormant local-mean variant (its numba loop
    is commented out upstream), vectorised: each occupied cell is
    compared against the mean of the occupied cells in its N x N
    neighbourhood; cells below local_mean/level are raised to the
    local mean, and cells with fewer than N occupied neighbours are
    zeroed (too isolated to weight against)."""
    counts = np.asarray(counts).copy()
    ix, iy = np.where(counts > 0)
    if ix.size == 0:
        return counts
    if nbox is None:
        cnts = counts[ix, iy]
        med = np.median(cnts)
        counts[ix, iy] = np.maximum(cnts, med / level)
        return counts
    # box sums via 2D cumulative sums (O(npix), no scipy needed)
    occ = (counts > 0).astype(np.float64)

    def box_sum(a, n):
        c = np.cumsum(np.cumsum(a, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        h = n // 2
        nx, ny = a.shape
        i0 = np.clip(np.arange(nx) - h, 0, nx)
        i1 = np.clip(np.arange(nx) + n - h, 0, nx)
        j0 = np.clip(np.arange(ny) - h, 0, ny)
        j1 = np.clip(np.arange(ny) + n - h, 0, ny)
        return (c[i1][:, j1] - c[i0][:, j1] - c[i1][:, j0]
                + c[i0][:, j0])

    nocc = box_sum(occ, nbox)
    tot = box_sum(counts.astype(np.float64), nbox)
    with np.errstate(invalid="ignore", divide="ignore"):
        local_mean = np.where(nocc > 0, tot / np.maximum(nocc, 1), 0.0)
    sel = counts > 0
    too_isolated = sel & (nocc < nbox)
    low = sel & ~too_isolated & (counts < local_mean / level)
    counts[low] = local_mean[low]
    counts[too_isolated] = 0.0
    return counts
