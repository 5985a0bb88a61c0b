"""Measurement-operator products: dirty/PSF/PSFHAT/residual/weights in
one pass, and the vis-space Hessian.

JAX equivalent of pfb/operators/gridder.py:551-740
(image_data_products) and pfb/operators/hessian.py:11-126 (hessian_xds).
The (de)gridding backend is 'wgrid' (ES-kernel w-stacking gridder,
XLA scatter-add, pfb_tpu/ops/wgridder.py — the workers' default) or
'dft' (exact, the oracle).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pfb_tpu.ops.dft import dirty2vis_dft, vis2dirty_dft
from pfb_tpu.ops.fft import make_psfhat
from pfb_tpu.ops.weighting import counts_to_weights


# the gridder engine the workers default to; "dft" is the exact
# O(nvis * npix) oracle
DEFAULT_BACKEND = "wgrid"


def get_backend(backend, epsilon=None, do_wgridding=None,
                double_accum=None):
    """(dirty2vis, vis2dirty) for the named backend. When epsilon /
    do_wgridding / double_accum are given they are bound into the
    returned callables (the schema->CLI->backend plumbing of reference
    pfb/parser/gridding.yml:1-5); the exact-DFT oracle maps
    do_wgridding onto its do_wterm switch and is compensated-precision
    by construction (no epsilon / double_accum). These plan on every
    call; :class:`Gridder` plans once."""
    if backend == "dft":
        d2v, v2d = dirty2vis_dft, vis2dirty_dft
        if do_wgridding is not None:
            d2v = partial(d2v, do_wterm=do_wgridding)
            v2d = partial(v2d, do_wterm=do_wgridding)
        return d2v, v2d
    if backend != "wgrid":
        raise ValueError(f"Unknown gridder backend {backend}")
    from pfb_tpu.ops.wgridder import dirty2vis_wgrid, vis2dirty_wgrid
    d2v, v2d = dirty2vis_wgrid, vis2dirty_wgrid
    kw = {}
    if epsilon is not None:
        kw["epsilon"] = epsilon
    if do_wgridding is not None:
        kw["do_wgridding"] = do_wgridding
    if kw:
        d2v, v2d = partial(d2v, **kw), partial(v2d, **kw)
    if double_accum is not None:
        v2d = partial(v2d, double_accum=double_accum)
    return d2v, v2d


class Gridder:
    """R and R.H for one dataset's (uvw, freq) on one image geometry,
    planned once and reused across calls (the major cycle applies the
    same operator every iteration).

    ``dirty2vis(image, split=False)`` and ``vis2dirty(vis, wgt=None,
    mask=None)`` keep everything on the device; ``vis`` may be complex
    or a (real, imag) pair. ``device`` commits the plan to one device.
    """

    def __init__(self, backend, uvw, freq, *, nx, ny, cell, epsilon=1e-7,
                 do_wgridding=True, x0=0.0, y0=0.0, double_accum=False,
                 device=None):
        self.backend, self.nx, self.ny = backend, nx, ny
        self.cell, self.x0, self.y0 = float(cell), float(x0), float(y0)
        self.double_accum = double_accum
        kw = dict(nx=nx, ny=ny, cellx=self.cell, celly=self.cell,
                  epsilon=epsilon, do_wgridding=do_wgridding,
                  x0=self.x0, y0=self.y0)
        if backend == "wgrid":
            from pfb_tpu.ops.wgridder import wgrid_plan
            self.plan = wgrid_plan(uvw, freq, device=device, **kw)
        elif backend == "dft":
            self.plan = None
            self.do_wterm = do_wgridding
            self.uvw = jax.device_put(uvw, device)
            self.freq = jax.device_put(freq, device)
        else:
            raise ValueError(f"Unknown gridder backend {backend}")
        self.nw = self.plan["nw"] if self.plan is not None else 1

    def dirty2vis(self, image, split=False):
        if self.plan is None:
            return dirty2vis_dft(self.uvw, self.freq, image, self.cell,
                                 self.cell, x0=self.x0, y0=self.y0,
                                 do_wterm=self.do_wterm, split=split)
        from pfb_tpu.ops.wgridder import dirty2vis_wgrid
        return dirty2vis_wgrid(None, None, image, self.cell, self.cell,
                               plan=self.plan, split=split)

    def vis2dirty(self, vis, wgt=None, mask=None):
        if self.plan is None:
            return vis2dirty_dft(self.uvw, self.freq, vis, wgt=wgt,
                                 mask=mask, nx=self.nx, ny=self.ny,
                                 cellx=self.cell, celly=self.cell,
                                 x0=self.x0, y0=self.y0,
                                 do_wterm=self.do_wterm)
        from pfb_tpu.ops.wgridder import vis2dirty_wgrid
        return vis2dirty_wgrid(None, None, vis, wgt=wgt, mask=mask,
                               nx=self.nx, ny=self.ny, cellx=self.cell,
                               celly=self.cell, plan=self.plan,
                               double_accum=self.double_accum)


def row_bucket(nrow, minimum=64):
    """Round a row count up to the next bucket so datasets with
    different row counts share one compiled exact-DFT program.
    Buckets step by 1.5x-ish (64, 96, 128, 192, 256, ...): at most
    ~50% padded work just above a boundary instead of the ~100% a
    power-of-two ladder costs, for 2x the compile-cache entries."""
    n = minimum
    while n < nrow:
        h = n + n // 2
        if nrow <= h:
            return h
        n *= 2
    return n


def pad_rows(nrow_to, uvw, *arrays):
    """Zero-pad the row axis of uvw and per-(row, chan) arrays to
    ``nrow_to``. Padded rows carry zero weight/mask so they contribute
    nothing to gridded products; degrid callers must crop the output
    back to the true row count."""
    npad = nrow_to - uvw.shape[0]
    if npad == 0:
        return (uvw,) + arrays
    out = [jnp.pad(uvw, ((0, npad), (0, 0)))]
    for a in arrays:
        if a is None:
            out.append(None)
        else:
            out.append(jnp.pad(a, ((0, npad), (0, 0))))
    return tuple(out)


def image_data_products(uvw, freq, vis, wgt, mask, counts,
                        nx, ny, nx_psf, ny_psf, cellx, celly,
                        model=None, robustness=None, x0=0.0, y0=0.0,
                        l2reweight_dof=None, do_dirty=True, do_psf=True,
                        do_weight=True, do_residual=True, backend="dft",
                        epsilon=1e-7, do_wgridding=True,
                        double_accum=False):
    """Compute DIRTY, WSUM, PSF(+PSFHAT), RESIDUAL and effective WEIGHT
    for one (time, band) dataset in one go
    (reference: pfb/operators/gridder.py:551-740).

    All inputs are arrays for one dataset: uvw (nrow,3), freq (nchan,),
    vis/wgt/mask (nrow, nchan), counts (nx, ny) or None.
    Returns a dict keyed with the reference's dds field names.

    The image and PSF gridders are planned once per call and shared by
    every product; for the exact DFT, rows are zero-padded to a bucket
    so different datasets share one compiled program (padded rows have
    zero weight/mask).
    """
    assert cellx == celly, "square cells only"
    out = {}

    nrow = uvw.shape[0]
    if backend == "dft":
        uvw, vis, wgt, mask = pad_rows(row_bucket(nrow), uvw, vis, wgt,
                                       mask)
    gkw = dict(cell=cellx, epsilon=epsilon, do_wgridding=do_wgridding,
               x0=x0, y0=y0, double_accum=bool(double_accum))
    g_img = None
    if do_dirty or model is not None:
        g_img = Gridder(backend, uvw, freq, nx=nx, ny=ny, **gkw)

    residual_vis = None
    if model is not None:
        mr, mi = g_img.dirty2vis(jnp.asarray(model), split=True)
        vis = jnp.asarray(vis)
        rr = (jnp.real(vis) - mr) * mask
        ri = (jnp.imag(vis) - mi) * mask
        residual_vis = (rr, ri)

    if l2reweight_dof:
        if residual_vis is None:
            raise ValueError(
                "Requested l2 reweight but no model passed in.")
        ressq = residual_vis[0] ** 2 + residual_vis[1] ** 2
        wcount = mask.sum()
        ovar = ressq.sum() / wcount
        wgt = (l2reweight_dof + 1) / (l2reweight_dof + ressq / ovar) / ovar

    if robustness is not None:
        if counts is None:
            raise ValueError(
                "counts are None but robustness specified.")
        imwgt = counts_to_weights(counts, uvw, freq, nx, ny,
                                  cellx, celly, robustness)
        wgt = imwgt if wgt is None else wgt * imwgt

    if do_weight:
        out["WEIGHT"] = wgt[:nrow]

    mb = mask.astype(bool)
    wsum = jnp.where(mb, wgt, 0.0).sum()
    out["WSUM"] = jnp.atleast_1d(wsum)

    if do_dirty:
        out["DIRTY"] = g_img.vis2dirty(vis, wgt=wgt, mask=mask)

    if do_psf:
        g_psf = Gridder(backend, uvw, freq, nx=nx_psf, ny=ny_psf, **gkw)
        rdt = jnp.finfo(jnp.asarray(vis).dtype).dtype
        if x0 or y0:
            # PSF visibilities at the shifted phase centre: transform of
            # a unit delta at (x0, y0) (reference gridder.py:659-687)
            delta = jnp.zeros((128, 128), rdt).at[64, 64].set(1.0)
            g_delta = Gridder(backend, uvw, freq, nx=128, ny=128, **gkw)
            psf_vis = g_delta.dirty2vis(delta, split=True)
        else:
            ones = jnp.ones(jnp.shape(vis), rdt)
            psf_vis = (ones, jnp.zeros_like(ones))
        psf = g_psf.vis2dirty(psf_vis, wgt=wgt, mask=mask)
        out["PSF"] = psf
        out["PSFHAT"] = make_psfhat(psf)

    if model is not None and do_residual:
        out["RESIDUAL"] = g_img.vis2dirty(residual_vis, wgt=wgt,
                                          mask=mask)

    return out


def hessian_slice(x, uvw, freq, wgt, mask, cellx, celly, x0=0.0, y0=0.0,
                  beam=None, backend="dft", epsilon=None,
                  do_wgridding=None):
    """One-dataset vis-space Hessian: beam * R.H W R (beam * x)
    (reference: pfb/operators/hessian.py:62-106, divide_by_n=False)."""
    d2v, v2d = get_backend(backend, epsilon, do_wgridding)
    uvw, wgt, mask = pad_rows(row_bucket(uvw.shape[0]), uvw, wgt, mask)
    xin = x * beam if beam is not None else x
    mr, mi = d2v(uvw, freq, xin, cellx, celly, x0=x0, y0=y0,
                 split=True)
    conv = v2d(uvw, freq, (mr * mask, mi * mask), wgt=wgt, mask=mask,
               nx=x.shape[0], ny=x.shape[1], cellx=cellx, celly=celly,
               x0=x0, y0=y0)
    if beam is not None:
        conv = conv * beam
    return conv


def stack_dds(dds, nband, use_beam=True, mask_image=None):
    """Stack per-band dataset lists into dense (nband, ndata, ...)
    arrays for batched/scanned Hessian evaluation. Padding datasets,
    rows AND channels carry zero weight+mask so they contribute
    nothing (ragged channel chunks — e.g. 8 channels imaged 3+3+2 —
    pad to the widest); every dataset must share the cell size (one
    compiled program)."""
    by_band = [[] for _ in range(nband)]
    for ds in dds:
        by_band[ds["bandid"]].append(ds)
    ndata = max(len(g) for g in by_band)
    R = row_bucket(max(ds["UVW"].shape[0] for ds in dds))
    nchan = max(ds["FREQ"].shape[0] for ds in dds)
    cell = float(dds[0]["cell_rad"])
    x0 = float(dds[0].get("x0", 0.0))
    y0 = float(dds[0].get("y0", 0.0))
    for ds in dds:
        assert float(ds["cell_rad"]) == cell, "mixed cell sizes"

    uvw = np.zeros((nband, ndata, R, 3))
    frq = np.ones((nband, ndata, nchan))
    wgt = np.zeros((nband, ndata, R, nchan))
    msk = np.zeros((nband, ndata, R, nchan))
    beam = None
    has_beam = use_beam and any("BEAM" in ds for ds in dds)
    if has_beam or mask_image is not None:
        nx, ny = dds[0]["DIRTY"].shape if "DIRTY" in dds[0] else \
            mask_image.shape
        beam = np.ones((nband, ndata, nx, ny))
    for b, group in enumerate(by_band):
        for d, ds in enumerate(group):
            nr = ds["UVW"].shape[0]
            nc = ds["FREQ"].shape[0]
            uvw[b, d, :nr] = ds["UVW"]
            frq[b, d, :nc] = ds["FREQ"]
            wgt[b, d, :nr, :nc] = ds["WEIGHT"]
            msk[b, d, :nr, :nc] = ds["MASK"]
            if beam is not None:
                bm = ds["BEAM"] if (use_beam and "BEAM" in ds) else 1.0
                if mask_image is not None:
                    bm = bm * mask_image
                beam[b, d] = bm
    return dict(uvw=uvw, freq=frq, wgt=wgt, mask=msk, beam=beam,
                cell=cell, x0=x0, y0=y0, ndata=ndata, R=R,
                nchan=nchan)


def _hessian_stacked_local(x, uvw, frq, wgt, msk, beam, *, cell, x0,
                           y0, nx, ny):
    """R.H W R per band over stacked datasets: vmap over the band axis,
    scan over the dataset axis (exact DFT)."""
    def one_band(x_b, uvw_b, frq_b, wgt_b, msk_b, beam_b):
        def one_ds(acc, args):
            u, f, w, m, bm = args
            xin = x_b * bm if bm is not None else x_b
            mvis = dirty2vis_dft(u, f, xin, cell, cell, x0=x0, y0=y0)
            conv = vis2dirty_dft(u, f, mvis * m, wgt=w, mask=m, nx=nx,
                                 ny=ny, cellx=cell, celly=cell, x0=x0,
                                 y0=y0)
            if bm is not None:
                conv = conv * bm
            return acc + conv, None
        xs = (uvw_b, frq_b, wgt_b, msk_b)
        if beam_b is not None:
            out, _ = jax.lax.scan(
                lambda a, s: one_ds(a, s), jnp.zeros_like(x_b),
                xs + (beam_b,))
        else:
            out, _ = jax.lax.scan(
                lambda a, s: one_ds(a, s + (None,)),
                jnp.zeros_like(x_b), xs)
        return out

    if beam is not None:
        return jax.vmap(one_band)(x, uvw, frq, wgt, msk, beam)
    return jax.vmap(lambda *a: one_band(*a, None))(x, uvw, frq, wgt,
                                                   msk)


def _ds_beam(ds, use_beam, mask_image):
    """The image-space weighting of one dataset in the Hessian: its
    BEAM (when used) times the mask image, or None."""
    beam = None
    if use_beam and "BEAM" in ds:
        beam = np.asarray(ds["BEAM"])
    if mask_image is not None:
        mi = np.asarray(mask_image)
        beam = mi if beam is None else beam * mi
    return beam


def plan_hessian_datasets(dds, nx, ny, backend, epsilon=1e-7,
                          do_wgridding=True, use_beam=True,
                          mask_image=None, devices=None):
    """One planned R.H W R per dataset: a list of (bandid, gridder,
    weight, mask, beam) with every array committed to
    ``devices[bandid]`` (all on the default device when ``devices`` is
    None)."""
    ops = []
    for ds in dds:
        b = int(ds["bandid"])
        dev = devices[b] if devices is not None else None
        g = Gridder(backend, np.asarray(ds["UVW"]),
                         np.asarray(ds["FREQ"]), nx=nx, ny=ny,
                         cell=float(ds["cell_rad"]), epsilon=epsilon,
                         do_wgridding=do_wgridding,
                         x0=float(ds.get("x0", 0.0)),
                         y0=float(ds.get("y0", 0.0)), device=dev)
        dt = jnp.zeros(0).dtype
        wgt = jax.device_put(np.asarray(ds["WEIGHT"], dt), dev)
        msk = jax.device_put(np.asarray(ds["MASK"], dt), dev)
        beam = _ds_beam(ds, use_beam, mask_image)
        if beam is not None:
            beam = jax.device_put(beam.astype(dt), dev)
        ops.append((b, g, wgt, msk, beam))
    return ops


def hessian_planned(x_b, g, wgt, msk, beam):
    """beam * R.H W R (beam * x_b) for one planned dataset."""
    xin = x_b * beam if beam is not None else x_b
    mr, mi = g.dirty2vis(xin, split=True)
    conv = g.vis2dirty((mr, mi), wgt=wgt, mask=msk).astype(x_b.dtype)
    return conv * beam if beam is not None else conv


def make_hessian_dds(dds, nband, wsum, nx, ny, sigmainv=0.0,
                     mask_image=None, use_beam=True, backend="dft",
                     epsilon=1e-7, do_wgridding=True):
    """Build the exact-residual operator ONCE and reuse it across major
    iterations — replaces the per-call Python loop of
    :func:`hessian_dds` (reference pfb/operators/hessian.py:11-59).

    'wgrid': every dataset's gridder is planned once and the
    matvec chains the planned R and R.H per dataset. 'dft': a single
    compiled program over the stacked datasets.
    """
    if backend != "dft":
        ops = plan_hessian_datasets(dds, nx, ny, backend, epsilon,
                                    do_wgridding, use_beam, mask_image)

        def matvec_planned(x):
            x = jnp.asarray(x)
            conv = [jnp.zeros_like(x[0]) for _ in range(nband)]
            for b, g, wgt, msk, beam in ops:
                conv[b] = conv[b] + hessian_planned(x[b], g, wgt, msk,
                                                    beam)
            out = jnp.stack(conv) / wsum
            if sigmainv:
                out = out + x * sigmainv**2
            return out

        return matvec_planned

    st = stack_dds(dds, nband, use_beam=use_beam,
                   mask_image=mask_image)
    kern = partial(_hessian_stacked_local, cell=st["cell"],
                   x0=st["x0"], y0=st["y0"], nx=nx, ny=ny)
    args = [jnp.asarray(st["uvw"]), jnp.asarray(st["freq"]),
            jnp.asarray(st["wgt"]), jnp.asarray(st["mask"])]
    has_beam = st["beam"] is not None
    if has_beam:
        args.append(jnp.asarray(st["beam"]))

    @jax.jit
    def matvec_dft(x, *a):
        conv = kern(x, *a) if has_beam else kern(x, *a, None)
        out = conv / wsum
        if sigmainv:
            out = out + x * sigmainv**2
        return out

    def matvec(x):
        return matvec_dft(x, *args)

    return matvec


def hessian_dds(x, dds, wsum, sigmainv=0.0, mask_image=None,
                use_beam=True, backend="dft"):
    """Vis-space Hessian reduced over datasets: the exact residual
    operator of the major cycle (reference: hessian.py:11-59).

    ``x`` is the (nband, nx, ny) model cube; ``dds`` a list of dataset
    dicts each holding UVW/FREQ/WEIGHT/MASK (+ attrs bandid, cell_rad,
    x0, y0, optionally BEAM).
    """
    nband = x.shape[0]
    conv = [jnp.zeros_like(x[0]) for _ in range(nband)]
    for ds in dds:
        b = ds["bandid"]
        beam = None
        if use_beam and "BEAM" in ds:
            beam = jnp.asarray(ds["BEAM"])
            if mask_image is not None:
                beam = beam * mask_image
        elif mask_image is not None:
            beam = mask_image
        conv[b] = conv[b] + hessian_slice(
            x[b], jnp.asarray(ds["UVW"]), jnp.asarray(ds["FREQ"]),
            jnp.asarray(ds["WEIGHT"]), jnp.asarray(ds["MASK"]),
            ds["cell_rad"], ds["cell_rad"], x0=ds.get("x0", 0.0),
            y0=ds.get("y0", 0.0), beam=beam, backend=backend)
    out = jnp.stack(conv) / wsum
    if sigmainv:
        out = out + x * sigmainv**2
    return out


def make_hess_vis_dct(vis_ds, field_geom, sigmainv=1.0, backend="dft",
                      epsilon=None, do_wgridding=None):
    """Multi-field joint vis-space Hessian over a dict-keyed image set
    (reference hess_vis, pfb/operators/hessian.py:284-344): for each
    shared visibility dataset the model visibilities of EVERY field
    (each rendered at its own phase centre / cell size) are summed,
    then gridded back onto every field's grid — the cross-field
    coupling lives in the shared visibilities. The returned matvec
    maps ``{field: {key: (nx, ny) image}}`` to the same structure (a
    pytree, so :func:`pfb_tpu.opt.pcg.cg_dct` solves the joint
    system).

    ``vis_ds``: list of dataset dicts with UVW/FREQ/WEIGHT/MASK and a
    ``key`` entry naming the (time, band) slot; ``field_geom``:
    ``{field: dict(nx=, ny=, cell_rad=, x0=, y0=)}``.
    """
    d2v, v2d = get_backend(backend, epsilon, do_wgridding)

    def matvec(x):
        out = {f: {k: sigmainv * v for k, v in sub.items()}
               for f, sub in x.items()}
        for ds in vis_ds:
            key = ds["key"]
            uvw = jnp.asarray(ds["UVW"])
            freq = jnp.asarray(ds["FREQ"])
            wgt = jnp.asarray(ds["WEIGHT"])
            msk = jnp.asarray(ds["MASK"])
            mvis = None
            for f, g in field_geom.items():
                mv = d2v(uvw, freq, x[f][key], g["cell_rad"],
                         g["cell_rad"], x0=g.get("x0", 0.0),
                         y0=g.get("y0", 0.0))
                mvis = mv if mvis is None else mvis + mv
            mvis = mvis * msk
            for f, g in field_geom.items():
                out[f][key] = out[f][key] + v2d(
                    uvw, freq, mvis, wgt=wgt, mask=msk, nx=g["nx"],
                    ny=g["ny"], cellx=g["cell_rad"],
                    celly=g["cell_rad"], x0=g.get("x0", 0.0),
                    y0=g.get("y0", 0.0))
        return out

    return matvec
