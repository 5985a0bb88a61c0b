"""ES-kernel w-stacking (de)gridder — the FFT-based measurement
operator for large visibility counts.

A from-scratch JAX implementation of the semantics the reference
gets from ducc0.wgridder (pfb/operators/gridder.py:10): type-1/type-2
NUFFT on an oversampled uv grid using the "exponential of semicircle"
kernel

    C(x) = exp(beta * k * (sqrt(1 - x^2) - 1)),  |x| <= 1

with w-stacking for the non-coplanar term: visibilities are spread along
a third (w) axis with the same kernel, each w-plane is transformed and
phased by exp(+/- 2 pi i w (n-1)), and the final image is corrected by
the kernel's Fourier transform ("grid correction") in l, m and n-1.

Conventions identical to pfb_tpu.ops.dft (the exact oracle):
    degrid: vis = sum_lm I(l,m) exp(-2 pi i (u l + v m + w (n-1)) f/c)
    grid:   I   = sum_rc  wgt mask Re[vis exp(+2 pi i (...))]
with pixel centres l_i = (i - nx//2) cell.

The scatter/gather is XLA scatter-add over (vis, k, k) stencils,
chunked over visibilities to bound memory; every position is planned
once on the host in float64 (:func:`wgrid_plan`).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pfb_tpu.ops.dft import LIGHTSPEED, nterm


# per-support ES shape parameter and the max relative error it
# achieves vs the exact-DFT oracle at oversampling sigma=2 with
# w-gridding on (scripts/calibrate_beta.py). Odd supports land the
# nearest grid point at |offset| <= 0.5 and gain ~1.5 decades over the
# adjacent even support, so the ladder uses odd k beyond 4.
_BETA_TABLE = (
    (4, 2.40, 1.5e-02),
    (5, 2.25, 1.6e-04),
    (7, 2.30, 2.5e-06),
    (9, 2.25, 4.0e-08),
    (11, 2.27, 5.0e-10),
    (13, 2.30, 6.0e-12),
)


def kernel_params(epsilon):
    """(support k, beta) for a target accuracy at oversampling 2.0:
    the smallest calibrated support whose measured oracle error clears
    the requested epsilon with a 2x margin (the calibration is one
    random uv case; the margin absorbs case-to-case variation)."""
    for k, beta, err in _BETA_TABLE:
        if err <= 0.5 * epsilon:
            return k, beta
    return _BETA_TABLE[-1][0], _BETA_TABLE[-1][1]


def es_kernel(x, beta, k):
    arg = jnp.maximum(1.0 - x * x, 0.0)
    return jnp.where(jnp.abs(x) <= 1.0,
                     jnp.exp(beta * k * (jnp.sqrt(arg) - 1.0)), 0.0)


def _es_kernel_ft(theta, beta, k, nquad=64):
    """Continuous Fourier transform of the ES kernel (support [-k/2,
    k/2] grid cells): c_hat(theta) = int C(2x/k) e^{2 pi i x theta} dx,
    computed by Gauss-Legendre quadrature (real, even)."""
    # integrate over x in [0, k/2], doubled (even kernel)
    xq, wq = np.polynomial.legendre.leggauss(nquad)
    xq = 0.5 * (xq + 1.0) * (k / 2.0)  # [0, k/2]
    wq = wq * (k / 4.0)
    xq = jnp.asarray(xq)
    wq = jnp.asarray(wq)
    cx = es_kernel(xq / (k / 2.0), beta, k)
    # theta (...,) -> (..., nquad)
    ph = 2.0 * jnp.pi * theta[..., None] * xq
    return 2.0 * jnp.sum(wq * cx * jnp.cos(ph), axis=-1)


def _grid_setup(nx, ny, cellx, celly, sigma):
    N_x = int(sigma * nx)
    N_y = int(sigma * ny)
    # make even for clean rolls
    N_x += N_x % 2
    N_y += N_y % 2
    return N_x, N_y


def _taps(f, beta, k):
    """ES kernel weights at the k grid offsets around a rounded
    position; ``f`` (n,) is the position minus its rounded value."""
    korig = (k - 1) // 2
    offs = jnp.arange(-korig, k - korig, dtype=f.dtype)
    return es_kernel((offs - f[:, None]) / (k / 2.0), beta, k)


def _stencil(pos, beta, k, Nx, Ny, nw, do_w, dtype, pstart=0, nb=None):
    """Per-visibility spreading stencil of one chunk: the (n, k, k)
    uv kernel product, its wrapped grid indices and, with w-stacking,
    the (n, k) w-tap weights and plane indices relative to the plane
    block [pstart, pstart + nb) — ``nb`` (out of range) for taps that
    fall outside it."""
    u0, fu, v0, fv, p0, fw = pos
    korig = (k - 1) // 2
    offs = jnp.arange(-korig, k - korig, dtype=jnp.int32)
    cu = _taps(fu.astype(dtype), beta, k)
    cv = _taps(fv.astype(dtype), beta, k)
    uv = cu[:, :, None] * cv[:, None, :]
    xim = jnp.mod(u0[:, None] + offs, Nx)
    yim = jnp.mod(v0[:, None] + offs, Ny)
    if do_w:
        nb = nw if nb is None else nb
        cw = _taps(fw.astype(dtype), beta, k)
        pic = jnp.clip(p0[:, None] + offs, 0, nw - 1) - pstart
        pic = jnp.where((pic >= 0) & (pic < nb), pic, nb)
    else:
        cw = jnp.ones(u0.shape + (1,), dtype)
        pic = jnp.zeros(u0.shape + (1,), jnp.int32)
    return uv, xim, yim, cw, pic


def _block_slice(arrays, lo, n, M):
    """The M-entry window [lo, lo + M) of each flat array, with entries
    past ``n`` zeroed (they belong to no visibility of the block)."""
    valid = jnp.arange(M) < n
    return tuple(jnp.where(valid, lax.dynamic_slice_in_dim(a, lo, M), 0)
                 for a in arrays)


@partial(jax.jit, static_argnames=("k", "Nx", "Ny", "nw", "nb", "do_w",
                                   "chunk", "M"))
def _spread(pos, vr, vi, beta, lo, n, pstart, *, k, Nx, Ny, nw, nb, do_w,
            chunk, M):
    """Scatter-add the weighted visibilities [lo, lo + n) of the flat
    (plane-sorted) arrays onto the (nb, Nx, Ny) oversampled grid stack
    of the planes [pstart, pstart + nb), as separate real and imaginary
    grids. ``M`` (a multiple of ``chunk``) is the static window size."""
    dtype = vr.dtype
    nck = M // chunk
    blk = _block_slice(tuple(pos) + (vr, vi), lo, n, M)

    def body(carry, a):
        gr, gi = carry
        pos_c, vrc, vic = a[:6], a[6], a[7]
        uv, xim, yim, cw, pic = _stencil(pos_c, beta, k, Nx, Ny, nw,
                                         do_w, dtype, pstart, nb)
        shape = uv.shape
        xidx = jnp.broadcast_to(xim[:, :, None], shape).reshape(-1)
        yidx = jnp.broadcast_to(yim[:, None, :], shape).reshape(-1)
        # the w taps loop in Python (k is small and static): the full
        # (n, k, k, k) stencil would be k times the memory
        for t in range(cw.shape[1]):
            val = uv * cw[:, t, None, None]
            pidx = jnp.broadcast_to(pic[:, t, None, None],
                                    shape).reshape(-1)
            gr = gr.at[pidx, xidx, yidx].add(
                (val * vrc[:, None, None]).reshape(-1), mode="drop")
            gi = gi.at[pidx, xidx, yidx].add(
                (val * vic[:, None, None]).reshape(-1), mode="drop")
        return (gr, gi), None

    grid0 = (jnp.zeros((nb, Nx, Ny), dtype),
             jnp.zeros((nb, Nx, Ny), dtype))
    xs = tuple(a.reshape(nck, chunk) for a in blk)
    (gr, gi), _ = lax.scan(body, grid0, xs)
    return gr, gi


def _w_params(uvw, freq, nm1_min, sigma, k):
    """w-stacking plane setup (host side, needs concrete values)."""
    wvals = np.abs(np.asarray(uvw[:, 2]))[:, None] * \
        (np.asarray(freq)[None, :] / LIGHTSPEED)
    wmax = wvals.max()
    wmin = -wmax  # symmetric since |exp phase| depends on sign
    # actual signed range:
    wsigned = np.asarray(uvw[:, 2])[:, None] * \
        (np.asarray(freq)[None, :] / LIGHTSPEED)
    wmin = wsigned.min()
    wmax = wsigned.max()
    dnmax = abs(nm1_min)  # max |n-1| on the image
    if dnmax == 0 or wmax == wmin:
        return 1, float(wmin), 1.0
    dw = 1.0 / (2.0 * sigma * dnmax)
    nw = int(np.ceil((wmax - wmin) / dw)) + k + 1
    w0 = wmin - (k / 2.0) * dw
    return nw, float(w0), float(dw)


def shift_phasor(uvw, freq, x0, y0, dtype, device=None):
    """(cos, sin) of 2 pi (u x0 + v y0) f/c per (row, chan), evaluated
    on the host in float64 — the phase that moves the image centre to
    (x0, y0) without touching the uv kernel positions — or None when
    the centre is not shifted."""
    if not (x0 or y0):
        return None
    uvw = np.asarray(uvw, np.float64)
    scale = np.asarray(freq, np.float64)[None, :] / LIGHTSPEED
    ph = 2.0 * np.pi * (uvw[:, 0:1] * x0 + uvw[:, 1:2] * y0) * scale
    return (jax.device_put(np.cos(ph).astype(dtype), device),
            jax.device_put(np.sin(ph).astype(dtype), device))


def _nm1_min(nx, ny, cellx, celly, x0, y0):
    """Most negative n - 1 over the image (host scalar)."""
    l = (np.arange(nx) - nx // 2) * cellx + x0
    m = (np.arange(ny) - ny // 2) * celly + y0
    eps_max = max(abs(l.min()), l.max()) ** 2 + \
        max(abs(m.min()), m.max()) ** 2
    return -eps_max / (np.sqrt(max(1.0 - eps_max, 0.0)) + 1.0)


# device bytes one w-plane block of the grid stack (real + imaginary)
# may take; the planes beyond it are gridded block by block
GRID_BLOCK_BYTES = 16 << 30
# visibilities per scatter/gather step (bounds the stencil temporaries)
VIS_CHUNK = 16384


def wgrid_plan(uvw, freq, *, nx, ny, cellx, celly, epsilon=1e-7,
               do_wgridding=True, sigma=2.0, x0=0.0, y0=0.0,
               dtype=None, device=None):
    """Reusable plan of the scatter-add gridder: geometry, w planes and
    every visibility's grid position, computed once on the host in
    float64 and split into an integer cell and a fraction. Only the
    fraction (|f| <= 0.5) reaches the device in ``dtype``, so a float32
    device run keeps the positions to ~1e-8 cells; positions computed
    on the device in float32 would be off by ~1e-3 cells at 4096^2.

    The w planes are gridded in blocks of as many planes as fit
    GRID_BLOCK_BYTES (whole FFT batches of 4 beyond 4): the
    visibilities are sorted by base plane on the host, so each block
    reads one contiguous window of those touching it, and only one
    block's grid stack is ever on the device — at 8192^2 (the PSF of a
    4096^2 image) the all-planes stack would not fit one card.
    ``device``
    commits the plan's arrays to one device (the band-sharded Hessian
    keeps each band's plan on its own card)."""
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # honours jax_enable_x64
    k, beta = kernel_params(epsilon)
    Nx, Ny = _grid_setup(nx, ny, cellx, celly, sigma)
    uvw = np.asarray(uvw, np.float64)
    freq = np.asarray(freq, np.float64)
    if do_wgridding:
        nw, w0, dw = _w_params(uvw, freq, _nm1_min(nx, ny, cellx, celly,
                                                   x0, y0), sigma, k)
    else:
        nw, w0, dw = 1, 0.0, 1.0
    do_w = nw > 1
    scale = freq[None, :] / LIGHTSPEED
    nrow, nchan = uvw.shape[0], freq.size
    nvis = nrow * nchan

    def split(a):
        a0 = np.round(a)
        return a0.astype(np.int32).ravel(), (a - a0).ravel()

    u0, fu = split(uvw[:, 0:1] * scale * cellx * Nx)
    v0, fv = split(uvw[:, 1:2] * scale * celly * Ny)
    if do_w:
        p0, fw = split((uvw[:, 2:3] * scale - w0) / dw)
    else:
        p0, fw = np.zeros(nvis, np.int32), np.zeros(nvis)

    plane_bytes = 2 * Nx * Ny * np.dtype(dtype).itemsize
    nb = max(1, GRID_BLOCK_BYTES // plane_bytes)
    if nb > 4:  # whole FFT batches (_grid_to_image's wchunk)
        nb -= nb % 4
    nb = int(min(nb, nw))
    nblk = -(-nw // nb)
    order = None
    if nblk > 1:
        # sort by base plane: the visibilities whose k taps touch a
        # block are then one contiguous window
        order = np.argsort(p0, kind="stable")
        u0, fu, v0, fv, p0, fw = (a[order] for a in (u0, fu, v0, fv,
                                                      p0, fw))
        korig = (k - 1) // 2
        starts = np.arange(nblk) * nb
        lo = np.searchsorted(p0, starts - (k - 1 - korig), "left")
        hi = np.searchsorted(p0, starts + nb - 1 + korig, "right")
    else:
        starts, lo, hi = np.zeros(1, int), np.zeros(1, int), \
            np.full(1, nvis)
    chunk = VIS_CHUNK
    M = max(chunk, -(-int((hi - lo).max()) // chunk) * chunk)
    total = max(nvis, int(lo.max()) + M)

    def put(a, dt):
        a = np.pad(a, (0, total - a.size)).astype(dt)
        return jax.device_put(a, device)

    pos = tuple(put(a, np.int32 if a.dtype == np.int32 else dtype)
                for a in (u0, fu, v0, fv, p0, fw))
    consts = jax.device_put(
        gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, dw, x0,
                  y0, rdtype=dtype), device)
    return dict(k=k, beta=beta, Nx=Nx, Ny=Ny, nw=nw, w0=w0, dw=dw,
                do_w=do_w, nx=nx, ny=ny, cellx=cellx, celly=celly,
                x0=x0, y0=y0, nrow=nrow, nchan=nchan, chunk=chunk,
                rdtype=np.dtype(dtype), pos=pos, nb=nb, M=M, total=total,
                blocks=[(int(s_), int(l_), int(h_ - l_))
                        for s_, l_, h_ in zip(starts, lo, hi)],
                order=None if order is None
                else jax.device_put(order.astype(np.int32), device),
                shift=shift_phasor(uvw, freq, x0, y0, dtype, device),
                consts=consts)


def vis2dirty_wgrid(uvw, freq, vis, wgt=None, mask=None, *, nx, ny,
                    cellx, celly, x0=0.0, y0=0.0, epsilon=1e-7,
                    do_wgridding=True, sigma=2.0, divide_by_n=False,
                    double_accum=False, plan=None):
    """R.H: visibilities -> dirty image via w-stacked ES gridding.
    ``vis`` may be complex or a (real, imag) pair. Pass
    plan=wgrid_plan(...) to reuse the geometry across calls."""
    p = plan or wgrid_plan(uvw, freq, nx=nx, ny=ny, cellx=cellx,
                           celly=celly, epsilon=epsilon,
                           do_wgridding=do_wgridding, sigma=sigma,
                           x0=x0, y0=y0)
    if isinstance(vis, (tuple, list)):
        vr, vi = jnp.asarray(vis[0]), jnp.asarray(vis[1])
    else:
        vis = jnp.asarray(vis)
        vr, vi = jnp.real(vis), jnp.imag(vis)
    rdtype = vr.dtype
    w = jnp.ones(vr.shape, rdtype) if wgt is None else \
        jnp.asarray(wgt, rdtype)
    if mask is not None:
        w = w * jnp.asarray(mask, rdtype)
    vr, vi = vr * w, vi * w
    if p["shift"] is not None:
        sr, si = p["shift"]
        vr, vi = vr * sr - vi * si, vr * si + vi * sr
    # gridding.yml double-accum: spread/accumulate in f64 for f32
    # inputs (only where x64 is enabled)
    if (double_accum and jax.config.jax_enable_x64
            and rdtype == jnp.float32):
        vr, vi = vr.astype(jnp.float64), vi.astype(jnp.float64)
    vr, vi = vr.ravel(), vi.ravel()
    if p["order"] is not None:
        vr, vi = vr[p["order"]], vi[p["order"]]
    npad = p["total"] - vr.size
    vr, vi = jnp.pad(vr, (0, npad)), jnp.pad(vi, (0, npad))
    consts = p["consts"] if rdtype == p["rdtype"] else None
    img = None
    for pstart, lo, n in p["blocks"]:
        gr, gi = _spread(p["pos"], vr, vi, p["beta"], lo, n, pstart,
                         k=p["k"], Nx=p["Nx"], Ny=p["Ny"], nw=p["nw"],
                         nb=p["nb"], do_w=p["do_w"], chunk=p["chunk"],
                         M=p["M"])
        part = _grid_to_image(
            gr.astype(rdtype), gi.astype(rdtype), nx, ny, p["cellx"],
            p["celly"], p["k"], p["beta"], p["Nx"], p["Ny"], p["do_w"],
            p["nb"], p["w0"] + pstart * p["dw"], p["dw"], divide_by_n,
            p["x0"], p["y0"], consts=consts)
        img = part if img is None else img + part
    return img


def _ifft2_stack(gr, gi):
    """Unnormalised inverse 2D FFT of a (..., N, N) real/imag pair."""
    full = jnp.fft.ifft2(lax.complex(gr, gi)) * \
        (gr.shape[-2] * gr.shape[-1])
    return full.real, full.imag


def _fft2_stack(xr, xi):
    """Forward 2D FFT of a (..., N, N) real/imag pair."""
    full = jnp.fft.fft2(lax.complex(xr, xi))
    return full.real, full.imag


@partial(jax.jit, static_argnames=("nx", "ny", "k", "Nx", "Ny",
                                   "do_w", "x0", "y0", "rdtype"))
def gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, dw,
              x0=0.0, y0=0.0, rdtype=jnp.float32):
    """Plan-invariant grid-correction / w-screen constants shared by
    :func:`_grid_to_image` and :func:`_image_to_grid`. These depend on
    the plan geometry only; the cw kernel-FT quadrature is a
    64-point Gauss-Legendre sum over the full image, so callers that
    reuse a plan can compute them once and pass them in."""
    li = (jnp.arange(nx) - nx // 2)
    mi = (jnp.arange(ny) - ny // 2)
    cx = _es_kernel_ft(li / Nx, beta, k).astype(rdtype)
    cy = _es_kernel_ft(mi / Ny, beta, k).astype(rdtype)
    ll = li * cellx + x0
    mm = mi * celly + y0
    llg, mmg = jnp.meshgrid(ll, mm, indexing="ij")
    nm1 = nterm(llg, mmg).astype(rdtype)
    out = dict(cx=cx, cy=cy, nm1=nm1)
    if do_w:
        # f32: 24-point quadrature (|theta| <= ~0.3 by the w-plane
        # sampling -> error ~1e-10, far below the f32 eps floor; the
        # 64-point default costs ~20 ms at 4096^2)
        nq = 24 if rdtype == jnp.float32 else 64
        out["cw"] = _es_kernel_ft(nm1 * dw, beta, k,
                                  nquad=nq).astype(rdtype)
        if rdtype == jnp.float32:
            tpi = jnp.asarray(2.0 * jnp.pi, rdtype)
            out["cd"] = jnp.cos(tpi * dw * nm1)
            out["sd"] = jnp.sin(tpi * dw * nm1)
    return out


@partial(jax.jit, static_argnames=("nx", "ny", "k", "Nx", "Ny", "nw",
                                   "do_w", "divide_by_n", "x0", "y0",
                                   "wchunk"))
def _grid_to_image(gr, gi, nx, ny, cellx, celly, k, beta, Nx, Ny, do_w,
                   nw, w0, dw, divide_by_n, x0=0.0, y0=0.0, wchunk=4,
                   consts=None):
    rdtype = gr.dtype

    if consts is None:
        consts = gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny,
                           do_w, dw, x0, y0, rdtype=rdtype)
    cx, cy, nm1 = consts["cx"], consts["cy"], consts["nm1"]

    def plane_images(grp, gip):
        # inverse DFT of a plane batch: sum_p G(p) e^{+2 pi i p s / N}
        ir, ii = _ifft2_stack(grp, gip)
        ir = jnp.roll(ir, (nx // 2, ny // 2), axis=(-2, -1))[..., :nx,
                                                            :ny]
        ii = jnp.roll(ii, (nx // 2, ny // 2), axis=(-2, -1))[..., :nx,
                                                            :ny]
        return ir, ii

    if do_w:
        # batches of wchunk planes: batched FFTs, then only the
        # REAL part of sum_p img_p e^{+2 pi i w_p (n-1)} is accumulated
        # (the imaginary part of the final image is discarded anyway)
        wc = min(wchunk, nw)
        nc = -(-nw // wc)
        npad = nc * wc - nw
        grp = jnp.pad(gr, ((0, npad), (0, 0), (0, 0)))
        gip = jnp.pad(gi, ((0, npad), (0, 0), (0, 0)))
        wp = w0 + dw * jnp.arange(nc * wc, dtype=rdtype)
        img0 = jnp.zeros((nx, ny), rdtype)

        if rdtype == jnp.float32:
            # f32 path: the per-plane w-screen cos/sin over the
            # image (nw transcendental passes) is replaced by a phasor
            # ROTATION recurrence — two cos/sin images total (w0 and
            # dw), then 4 mul + 2 add per plane. Rotation
            # drift is ~nw*2^-24 ~ 2e-6 relative at nw~30, below the
            # f32 gridder accuracy floor (eps >= 1e-5 in f32); the
            # f64/CPU parity path below keeps exact per-plane phases.
            tpi = jnp.asarray(2.0 * jnp.pi, rdtype)
            c0 = jnp.cos(tpi * w0 * nm1)
            s0 = jnp.sin(tpi * w0 * nm1)
            cd, sd = consts["cd"], consts["sd"]

            def accum(carry, args):
                img_a, c, s = carry
                grb, gib = args
                ir, ii = plane_images(grb, gib)
                tot = jnp.zeros_like(img_a)
                for j in range(wc):
                    tot = tot + ir[j] * c - ii[j] * s
                    c, s = c * cd - s * sd, s * cd + c * sd
                return (img_a + tot, c, s), None

            (img, _, _), _ = lax.scan(
                accum, (img0, c0, s0),
                (grp.reshape(nc, wc, Nx, Ny),
                 gip.reshape(nc, wc, Nx, Ny)))
        else:
            def accum(carry, args):
                grb, gib, wpb = args
                ir, ii = plane_images(grb, gib)
                ph = (2.0 * jnp.pi) * wpb[:, None, None] * nm1[None]
                contrib = ir * jnp.cos(ph) - ii * jnp.sin(ph)
                return carry + jnp.sum(contrib, axis=0), None

            img, _ = lax.scan(
                accum, img0,
                (grp.reshape(nc, wc, Nx, Ny),
                 gip.reshape(nc, wc, Nx, Ny), wp.reshape(nc, wc)))
        img = img / consts["cw"]
    else:
        img, _ = plane_images(gr[0], gi[0])

    out = img / (cx[:, None] * cy[None, :])
    if divide_by_n:
        out = out / (nm1 + 1.0)
    return out


def dirty2vis_wgrid(uvw, freq, image, cellx, celly, x0=0.0, y0=0.0, *,
                    epsilon=1e-7, do_wgridding=True, sigma=2.0,
                    divide_by_n=False, plan=None, split=False, **kw):
    """R: image -> visibilities (adjoint chain of vis2dirty_wgrid with
    the conjugate kernel: e^{-2 pi i(...)}). Returns complex
    (nrow, nchan) visibilities, or a (real, imag) pair when
    ``split``."""
    nx, ny = image.shape
    p = plan or wgrid_plan(uvw, freq, nx=nx, ny=ny, cellx=cellx,
                           celly=celly, epsilon=epsilon,
                           do_wgridding=do_wgridding, sigma=sigma,
                           x0=x0, y0=y0)
    image = jnp.asarray(image)
    consts = p["consts"] if image.dtype == p["rdtype"] else None
    fr = jnp.zeros(p["total"], image.dtype)
    fi = jnp.zeros(p["total"], image.dtype)
    for pstart, lo, n in p["blocks"]:
        gr, gi = _image_to_grid(image, nx, ny, p["cellx"], p["celly"],
                                p["k"], p["beta"], p["Nx"], p["Ny"],
                                p["do_w"], p["nb"],
                                p["w0"] + pstart * p["dw"], p["dw"],
                                divide_by_n, p["x0"], p["y0"],
                                split=True, consts=consts)
        fr, fi = _interp(p["pos"], gr, gi, p["beta"], lo, n, pstart, fr,
                         fi, k=p["k"], Nx=p["Nx"], Ny=p["Ny"],
                         nw=p["nw"], nb=p["nb"], do_w=p["do_w"],
                         chunk=p["chunk"], M=p["M"])
    nvis = p["nrow"] * p["nchan"]
    if p["order"] is not None:
        fr = jnp.zeros(nvis, fr.dtype).at[p["order"]].set(fr[:nvis])
        fi = jnp.zeros(nvis, fi.dtype).at[p["order"]].set(fi[:nvis])
    fr = fr[:nvis].reshape(p["nrow"], p["nchan"])
    fi = fi[:nvis].reshape(p["nrow"], p["nchan"])
    if p["shift"] is not None:
        sr, si = p["shift"]
        fr, fi = fr * sr + fi * si, fi * sr - fr * si
    if split:
        return fr, fi
    return lax.complex(fr, fi)


@partial(jax.jit, static_argnames=("nx", "ny", "k", "Nx", "Ny", "nw",
                                   "do_w", "divide_by_n", "x0", "y0",
                                   "split", "wchunk"))
def _image_to_grid(image, nx, ny, cellx, celly, k, beta, Nx, Ny, do_w,
                   nw, w0, dw, divide_by_n, x0=0.0, y0=0.0,
                   split=False, wchunk=4, consts=None):
    """split=True returns (real, imag) grids as two real arrays (the
    native representation — complex is only assembled on request for
    the wgrid backend's _interp)."""
    rdtype = image.dtype

    if consts is None:
        consts = gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny,
                           do_w, dw, x0, y0, rdtype=rdtype)
    cx, cy, nm1 = consts["cx"], consts["cy"], consts["nm1"]

    img = image / (cx[:, None] * cy[None, :])
    if divide_by_n:
        img = img / (nm1 + 1.0)

    def plane_grids(pr, pi):
        # embed at s = i - nx//2 (inverse of the roll+crop) and forward
        # DFT: G(p) = sum_s f(s) e^{-2 pi i p s / N}; batched over the
        # leading plane axis
        shape = pr.shape[:-2] + (Nx, Ny)
        fr = jnp.zeros(shape, rdtype).at[..., :nx, :ny].set(pr)
        fi = jnp.zeros(shape, rdtype).at[..., :nx, :ny].set(pi)
        fr = jnp.roll(fr, (-(nx // 2), -(ny // 2)), axis=(-2, -1))
        fi = jnp.roll(fi, (-(nx // 2), -(ny // 2)), axis=(-2, -1))
        return _fft2_stack(fr, fi)

    if do_w:
        img = img / consts["cw"]
        wc = min(wchunk, nw)
        nc = -(-nw // wc)
        wp = w0 + dw * jnp.arange(nc * wc, dtype=rdtype)

        # batches of wchunk planes: phase the image onto each plane and
        # run one batched FFT per chunk
        if rdtype == jnp.float32:
            # phasor-rotation recurrence (see _grid_to_image): phase
            # here is e^{-2 pi i w_p (n-1)} = (c_p, -s_p)
            tpi = jnp.asarray(2.0 * jnp.pi, rdtype)
            c0 = jnp.cos(tpi * w0 * nm1)
            s0 = jnp.sin(tpi * w0 * nm1)
            cd, sd = consts["cd"], consts["sd"]

            def one(carry, _):
                c, s = carry
                prs, pis = [], []
                for _j in range(wc):
                    prs.append(img * c)
                    pis.append(img * (-s))
                    c, s = c * cd - s * sd, s * cd + c * sd
                gr, gi = plane_grids(jnp.stack(prs), jnp.stack(pis))
                return (c, s), (gr, gi)

            _, (gr, gi) = lax.scan(one, (c0, s0), None, length=nc)
        else:
            def one(carry, wpb):
                ph = (-2.0 * jnp.pi) * wpb[:, None, None] * nm1[None]
                gr, gi = plane_grids(img[None] * jnp.cos(ph),
                                     img[None] * jnp.sin(ph))
                return carry, (gr, gi)

            _, (gr, gi) = lax.scan(one, 0, wp.reshape(nc, wc))
        if gr.ndim == 4:  # chunked scans emit (nc, wc, Nx, Ny)
            gr = gr.reshape(nc * wc, Nx, Ny)[:nw]
            gi = gi.reshape(nc * wc, Nx, Ny)[:nw]
    else:
        gr, gi = plane_grids(img[None], jnp.zeros_like(img)[None])

    if split:
        return gr, gi
    return lax.complex(gr, gi)


@partial(jax.jit, static_argnames=("k", "Nx", "Ny", "nw", "nb", "do_w",
                                   "chunk", "M"), donate_argnums=(7, 8))
def _interp(pos, gr, gi, beta, lo, n, pstart, fr, fi, *, k, Nx, Ny, nw,
            nb, do_w, chunk, M):
    """Gather twin of :func:`_spread`: adds the contributions of the
    (nb, Nx, Ny) real and imaginary grid stacks of the planes
    [pstart, pstart + nb) to the visibilities [lo, lo + n) of the flat
    (plane-sorted) accumulators ``fr``/``fi``."""
    dtype = gr.dtype
    nck = M // chunk
    blk = _block_slice(tuple(pos), lo, n, M)

    def chunk_fn(pos_c):
        uv, xim, yim, cw, pic = _stencil(pos_c, beta, k, Nx, Ny, nw,
                                         do_w, dtype, pstart, nb)
        accr = jnp.zeros(uv.shape[:1], dtype)
        acci = jnp.zeros(uv.shape[:1], dtype)
        for t in range(cw.shape[1]):
            inside = pic[:, t] < nb
            ix = (jnp.where(inside, pic[:, t], 0)[:, None, None],
                  xim[:, :, None], yim[:, None, :])
            val = uv * jnp.where(inside, cw[:, t], 0)[:, None, None]
            accr = accr + jnp.sum(gr[ix] * val, axis=(1, 2))
            acci = acci + jnp.sum(gi[ix] * val, axis=(1, 2))
        return accr, acci

    vr, vi = lax.map(chunk_fn, tuple(a.reshape(nck, chunk) for a in blk))
    valid = jnp.arange(M) < n
    vr = jnp.where(valid, vr.reshape(-1), 0)
    vi = jnp.where(valid, vi.reshape(-1), 0)
    fr = lax.dynamic_update_slice_in_dim(
        fr, lax.dynamic_slice_in_dim(fr, lo, M) + vr, lo, 0)
    fi = lax.dynamic_update_slice_in_dim(
        fi, lax.dynamic_slice_in_dim(fi, lo, M) + vi, lo, 0)
    return fr, fi
