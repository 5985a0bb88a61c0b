"""fluxmop worker: standalone forward (PCG) step.

Equivalent of pfb/workers/fluxmop.py:21-270: solve
A update = beam * mask * residual with the image-space (PSF) or
vis-space Hessian, add gamma * update to the model, recompute the exact
residual and write MODEL/MODELP/UPDATE/RESIDUAL back (MODELP kept to
revert on failure).
"""

import numpy as np

from pfb_tpu.ops.gridder import DEFAULT_BACKEND, make_hessian_dds
from pfb_tpu.ops.psf import hessian_psf_cube
from pfb_tpu.opt.pcg import pcg, pcg_bands
from pfb_tpu.utils import dstore
from pfb_tpu.utils.logging import get_logger
from pfb_tpu.workers.cubes import dds2cubes


log = get_logger("FLUXMOP")


def _fluxmop(ddsi=None, output_filename=None, product="I",
             suffix="main", nband=None, mask=None, min_model=0.0,
             zero_model_outside_mask=False, use_psf=True, sigmainv=1e-5,
             gamma=0.9, cg_tol=1e-5, cg_maxit=150, cg_minit=10,
             cg_verbose=0, cg_report_freq=10,
             backtrack=True, model_name="MODEL", backend=DEFAULT_BACKEND,
             epsilon=1e-7, do_wgridding=True, write=True,
             band_chunk=None, verbose=1, fits_mfs=False,
             fits_cubes=False, space_shards=0, **kw):
    """Returns (model, residual). Writes back into the dds store."""
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
    dirty, model, residual, psf, psfhat, beam, wsums, _ = dds2cubes(
        dds, nband, apparent=False, modelname=model_name)
    wsum = wsums.sum()
    if residual is None:
        residual = dirty.copy()
    nx, ny = dirty.shape[-2:]
    lastsize = dds[0]["PSF"].shape[-1]

    # exact-residual operator built once (one compiled program)
    hess0 = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                             backend=backend, epsilon=epsilon,
                             do_wgridding=do_wgridding)

    def hess_exact(m):
        return np.asarray(hess0(jnp.asarray(m)))

    # mask handling (reference fluxmop.py:126-156)
    if mask is None:
        mask_im = np.ones((nx, ny), dirty.dtype)
    elif isinstance(mask, str) and mask == "model":
        mask_im = np.any(model > min_model, axis=0).astype(dirty.dtype)
    else:
        mask_im = np.asarray(mask).astype(dirty.dtype)
        if zero_model_outside_mask:
            model[:, mask_im < 1] = 0
            residual = dirty - hess_exact(model)

    bm = jnp.asarray(beam * mask_im[None])
    b = bm * jnp.asarray(residual)

    if use_psf:
        A, b = _psf_hessian_maybe_space(b, bm, psfhat, lastsize,
                                        sigmainv, band_chunk, nband,
                                        nx, space_shards)
        update = np.asarray(pcg_bands(A, b, tol=cg_tol, maxit=cg_maxit,
                                      minit=cg_minit,
                                      backtrack=backtrack,
                                      verbosity=cg_verbose,
                                      report_freq=cg_report_freq))
    else:
        A = make_hessian_dds(dds, nband, wsum, nx, ny,
                             sigmainv=np.sqrt(sigmainv),
                             mask_image=mask_im, use_beam=False,
                             backend=backend, epsilon=epsilon,
                             do_wgridding=do_wgridding)

        update = np.asarray(pcg(A, b, tol=cg_tol, maxit=cg_maxit,
                                minit=cg_minit, backtrack=backtrack,
                                verbosity=cg_verbose,
                                report_freq=cg_report_freq))

    update = np.asarray(update)
    modelp = model.copy()
    model = model + gamma * update
    residual = dirty - hess_exact(model)

    if verbose:
        rmfs = residual.sum(axis=0)
        log.info(f"fluxmop: peak residual = {np.abs(rmfs).max():.3e}, "
              f"rms = {np.std(rmfs):.3e}")

    if write and dds_name is not None:
        for i, ds in enumerate(dds):
            bnd = ds["bandid"]
            arrays = {"RESIDUAL": residual[bnd] * wsum,
                      "MODEL": model[bnd],
                      "MODELP": modelp[bnd],
                      "UPDATE": update[bnd]}
            dstore.update_ds(dds_name, i, arrays)
            ds.update(arrays)

    # fits products (reference fluxmop.py fits-mfs/fits-cubes options)
    if (fits_mfs or fits_cubes) and output_filename is not None:
        from pfb_tpu.utils.fits import dds2fits, dds2fits_mfs
        base = f"{output_filename}_{product.upper()}_{suffix}"
        for col, norm in (("RESIDUAL", True), ("MODEL", False),
                          ("UPDATE", False)):
            if fits_mfs:
                dds2fits_mfs(dds, col, base, norm_wsum=norm)
            if fits_cubes:
                dds2fits(dds, col, base, norm_wsum=norm)

    return model, residual


def _psf_hessian_maybe_space(b, bm, psfhat, lastsize, sigmainv,
                             band_chunk, nband, nx, space_shards):
    """(A, b) for the PCG forward step: the single-program PSF Hessian,
    or — when ``space_shards`` > 1 and the device/shape constraints
    hold — the band+space-sharded distributed-rFFT2 Hessian
    (parallel/dist.py:hessian_psf_space_dist) with ``b`` laid out
    P('band', 'space', None) so the whole solve runs with the image
    plane sharded across chips (SURVEY.md section 5 long-context
    analogue, now reachable from a worker)."""
    import jax
    import jax.numpy as jnp

    ns = int(space_shards) if space_shards else 0
    if ns > 1:
        ndev = len(jax.devices())
        nb_ax = max(1, ndev // ns)
        if ns * nb_ax <= ndev and nx % ns == 0 and \
                nband % nb_ax == 0:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            from pfb_tpu.parallel.dist import (hessian_psf_space_dist,
                                               prep_psfhat_space)
            from pfb_tpu.parallel.mesh import make_mesh
            log.info("fluxmop: space-sharding the PCG forward step "
                     "over a (%d band x %d space) mesh", nb_ax, ns)
            mesh = make_mesh(nband=nb_ax, nspace=ns,
                             devices=jax.devices()[:nb_ax * ns])
            hd = hessian_psf_space_dist(mesh, lastsize, sigmainv=0.0)
            php = jax.device_put(
                prep_psfhat_space(jnp.asarray(psfhat), ns),
                NamedSharding(mesh, P("band", None, "space")))
            sh = NamedSharding(mesh, P("band", "space", None))
            bm_s = jax.device_put(bm, sh)
            b_s = jax.device_put(b, sh)

            def A(x):
                out = bm_s * hd(x * bm_s, php)
                return out + x * sigmainv if sigmainv else out

            return A, b_s
        log.warning(
            "fluxmop: space-shards=%d incompatible with %d device(s), "
            "nx=%d, nband=%d — using the single-program Hessian",
            ns, len(jax.devices()), nx, nband)

    psfhat_j = jnp.asarray(psfhat)

    def A(x):
        return hessian_psf_cube(x, psfhat_j, beam=bm,
                                lastsize=lastsize, sigmainv=sigmainv,
                                band_chunk=band_chunk)

    return A, b
