"""klean worker: modified single-scale CLEAN major cycle.

JAX equivalent of pfb/workers/klean.py:52-407: Clark minor
cycles on the apparent-scale residual, exact vis-space residual via the
dataset Hessian, threshold = sigmathreshold*rms or absolute, optional
PCG flux mop over the model-support mask, divergence guard, best-model
tracking, and MODEL/RESIDUAL/MODEL_BEST writeback to the dds store for
checkpoint/resume (resumes from the stored ``niters``).
"""

import numpy as np

from pfb_tpu.deconv.clark import clark
from pfb_tpu.ops.gridder import DEFAULT_BACKEND, make_hessian_dds
from pfb_tpu.opt.pcg import pcg_psf
from pfb_tpu.utils import dstore
from pfb_tpu.utils.logging import get_logger
from pfb_tpu.workers.cubes import dds2cubes


log = get_logger("KLEAN")


def _klean(ddsi=None, output_filename=None, product="I", suffix="main",
           nband=None, niter=5, threshold=None, sigmathreshold=2.0,
           gamma=0.05, peak_factor=0.05, sub_peak_factor=0.5,
           minor_maxit=50, subminor_maxit=1000, mop_flux=True,
           mop_gamma=0.65, dirosion=1, cg_tol=1e-5, cg_maxit=100,
           cg_minit=10, cg_verbose=0, cg_report_freq=10,
           backtrack=True, backend=DEFAULT_BACKEND,
           epsilon=1e-7, do_wgridding=True, mask=None,
           write=True, band_chunk=None, verbose=1, report_freq=1,
           fits_mfs=False, fits_cubes=False, **kw):
    """Returns (model, residual_cube). Writes back into the dds store."""
    import jax.numpy as jnp

    dds_name = None
    if ddsi is None:
        dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dds = dstore.read_store(dds_name)
    else:
        dds = ddsi
        if output_filename is not None:
            dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
            if not dstore.store_exists(dds_name):
                dstore.write_store(dds_name, dds)

    freqs_out = np.unique([ds["freq_out"] for ds in dds])
    nband = freqs_out.size if nband is None else nband
    nx, ny = dds[0]["DIRTY"].shape
    ny_psf = dds[0]["PSF"].shape[-1]

    # clean in apparent scale (reference klean.py:111-116)
    dirty, model, residual, psf, psfhat, _, wsums, _ = dds2cubes(
        dds, nband, apparent=True)
    wsum = wsums.sum()
    if residual is None:
        residual = dirty.copy()
    residual_mfs = residual.sum(axis=0)

    iter0 = int(dds[0].get("niters", 0))

    if mask is None:
        mask_im = np.ones((nx, ny), dirty.dtype)
    else:
        mask_im = mask.astype(dirty.dtype)

    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = model.copy()
    diverge_count = 0
    thresholdf = sigmathreshold * rms if threshold is None else threshold

    psfhat_j = jnp.asarray(psfhat)
    psf_j = jnp.asarray(psf)
    wsums_j = jnp.asarray(wsums / wsum)

    # exact-residual operator built once and reused across major
    # iterations (reference klean.py:175-178)
    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            backend=backend, epsilon=epsilon,
                            do_wgridding=do_wgridding)

    if verbose:
        log.info(f"klean iter {iter0}: peak residual = {rmax:.3e}, "
              f"rms = {rms:.3e}")

    for k in range(iter0, iter0 + niter):
        x, IR, status = clark(jnp.asarray(mask_im * residual), psf_j,
                              psfhat_j, wsums_j,
                              threshold=thresholdf, gamma=gamma,
                              pf=peak_factor, maxit=minor_maxit,
                              subpf=sub_peak_factor,
                              submaxit=subminor_maxit,
                              band_chunk=band_chunk)
        status = int(status)
        model = model + np.asarray(x)

        # exact residual (reference klean.py:267-272)
        conv = np.asarray(hess(jnp.asarray(model)))
        residual = dirty - conv
        residual_mfs = residual.sum(axis=0)

        rmsp = rms
        tmp_mask = ~np.any(model, axis=0)
        rms = np.std(residual_mfs[tmp_mask]) if tmp_mask.any() else \
            np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        if rms < best_rms:
            best_rms, best_rmax = rms, rmax
            best_model = model.copy()
        thresholdf = sigmathreshold * rms if threshold is None else \
            threshold

        # flux mop when stalled / converged / last iter
        # (reference klean.py:295-350)
        status |= k == iter0 + niter - 1
        status |= rmax <= thresholdf
        if mop_flux and status:
            mopmask = np.any(model, axis=0)
            if dirosion:
                from scipy import ndimage
                struct = ndimage.generate_binary_structure(2, dirosion)
                mopmask = ndimage.binary_dilation(mopmask,
                                                  structure=struct)
                mopmask = ndimage.binary_erosion(mopmask,
                                                 structure=struct)
            x0 = np.zeros_like(model)
            x0[:, mopmask] = residual_mfs[mopmask]
            mopmask_f = mopmask[None].astype(residual.dtype)
            x = pcg_psf(psfhat_j, jnp.asarray(mopmask_f * residual),
                        jnp.asarray(x0),
                        beam=jnp.asarray(np.broadcast_to(
                            mopmask_f, residual.shape)),
                        sigmainv=float(rmax), tol=cg_tol, maxit=cg_maxit,
                        minit=cg_minit, backtrack=backtrack,
                        verbosity=cg_verbose,
                        report_freq=cg_report_freq)
            model = model + mop_gamma * np.asarray(x)

            conv = np.asarray(hess(jnp.asarray(model)))
            residual = dirty - conv
            residual_mfs = residual.sum(axis=0)
            rmsp = rms
            tmp_mask = ~np.any(model, axis=0)
            rms = np.std(residual_mfs[tmp_mask]) if tmp_mask.any() else \
                np.std(residual_mfs)
            rmax = np.abs(residual_mfs).max()
            if rms < best_rms:
                best_rms, best_rmax = rms, rmax
                best_model = model.copy()
            thresholdf = sigmathreshold * rms if threshold is None else \
                threshold

        if verbose and (k + 1 - iter0) % max(report_freq, 1) == 0:
            log.info(f"klean iter {k + 1}: peak residual = {rmax:.3e}, "
                  f"rms = {rms:.3e}")

        if write and dds_name is not None:
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "MODEL_BEST": best_model[b]}
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if rmax <= thresholdf:
            if verbose:
                log.info("klean: terminating, threshold reached")
            break
        if rms > rmsp:
            diverge_count += 1
            if diverge_count > 3:
                log.info("klean: algorithm diverging, terminating")
                break

    # fits products (reference klean.py dds2fits_mfs/dds2fits calls)
    if (fits_mfs or fits_cubes) and output_filename is not None:
        from pfb_tpu.utils.fits import dds2fits, dds2fits_mfs
        base = f"{output_filename}_{product.upper()}_{suffix}"
        if fits_mfs:
            dds2fits_mfs(dds, "RESIDUAL", base, norm_wsum=True)
            dds2fits_mfs(dds, "MODEL", base, norm_wsum=False)
        if fits_cubes:
            dds2fits(dds, "RESIDUAL", base, norm_wsum=True)
            dds2fits(dds, "MODEL", base, norm_wsum=False)

    return model, residual
