"""spotless worker: SARA wavelet-sparsity deconvolution (the PFB core).

JAX equivalent of pfb/workers/spotless.py:57-426: image-space
PSF-Hessian, power-method spectral norm, SARA dictionary, per-major-
iteration primal-dual backward step with positivity, exact vis-space
residual, l1-reweighting from iteration l1reweight_from, divergence
guard and MODEL/DUAL/RESIDUAL/MODEL_BEST writeback for resume.
"""

from functools import partial

import numpy as np

from pfb_tpu.ops.gridder import DEFAULT_BACKEND, make_hessian_dds
from pfb_tpu.ops.psf import make_psf_convolve
from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu.opt.power_method import make_power_method_fused
from pfb_tpu.opt.primal_dual import make_primal_dual_fused
from pfb_tpu.utils import dstore
from pfb_tpu.utils.logging import get_logger
from pfb_tpu.utils.misc import fitcleanbeam
from pfb_tpu.workers.cubes import dds2cubes


log = get_logger("SPOTLESS")


def _spotless(ddsi=None, output_filename=None, product="I",
              suffix="main", nband=None, niter=5, tol=5e-4,
              rmsfactor=1.0, init_factor=0.5, gamma=1.0, bases="self,db1,db2",
              nlevels=3, l1reweight_from=5, alpha=4.0, hessnorm=None,
              pm_tol=1e-5, pm_maxit=100, pm_verbose=0,
              pm_report_freq=100, pd_tol=1e-5, pd_maxit=500,
              pd_verbose=0, pd_report_freq=50, positivity=1,
              epsilon=1e-7, do_wgridding=True, backend=DEFAULT_BACKEND,
              diverge_count=3,
              write=True, band_chunk=None, verbose=1,
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

    dirty, model, residual, psf, psfhat, beam, wsums, dual = dds2cubes(
        dds, nband, apparent=False)
    wsum = wsums.sum()
    psf_mfs = psf.sum(axis=0)
    assert (psf_mfs.max() - 1.0) < 2 * epsilon  # reference spotless.py:149
    if residual is None:
        residual = dirty.copy()
    residual_mfs = residual.sum(axis=0)

    iter0 = int(dds[0].get("niters", 0))

    # the PSF-Hessian enters every solver as a jit ARGUMENT through the
    # .apply/.consts hooks: a closed-over 2 GB PSFHAT (4096^2 x 8,
    # psf_oversize=2) would be baked into the executable
    psf_convolve = make_psf_convolve(jnp.asarray(psfhat), ny_psf,
                                     band_chunk=band_chunk)
    if hessnorm is None:
        import jax
        pm = make_power_method_fused(psf_convolve.apply, tol=pm_tol,
                                     maxit=pm_maxit, verbosity=pm_verbose,
                                     report_freq=pm_report_freq)
        b0 = jax.random.normal(jax.random.PRNGKey(42), (nband, nx, ny),
                               dirty.dtype)
        hessnorm, _ = pm(b0, psf_convolve.consts)
        hessnorm = float(hessnorm) * 1.05  # reference spotless.py:193
    if verbose:
        log.info(f"spotless: hessnorm = {hessnorm:.3e}")

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)
    psiH = partial(psi_dot, psi=psi)
    psiF = partial(psi_hdot, psi=psi)

    # pixels per beam from the fitted clean beam
    # (reference spotless.py:205-211)
    GaussPar = fitcleanbeam(psf_mfs[None], level=0.5, pixsize=1.0)[0]
    pix_per_beam = GaussPar[0] * GaussPar[1] * np.pi / 4
    if verbose:
        log.info(f"spotless: pixels per beam = {pix_per_beam:.2f}")

    # rms in coefficient space (reference spotless.py:213-223)
    fsel = wsums > 0

    def coeff_rms(img_cube):
        tmp = img_cube.copy()
        tmp[fsel] *= wsum / wsums[fsel, None, None]
        coeffs = np.asarray(psiH(jnp.asarray(tmp / pix_per_beam)))
        return np.std(coeffs.sum(axis=0), axis=(-1, -2))[:, None, None]

    rms_comps = coeff_rms(residual)

    if dual is None or dual.shape[1] != nbasis:
        dual = np.zeros((nband, nbasis, psi.Nymax, psi.Nxmax),
                        dirty.dtype)
    if "L1WEIGHT" in dds[0]:  # resume (reference spotless.py:536-546)
        l1weight = jnp.asarray(np.asarray(dds[0]["L1WEIGHT"],
                                          dirty.dtype))
    else:
        l1weight = jnp.ones((nbasis, psi.Nymax, psi.Nxmax),
                            dirty.dtype)

    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = model.copy()
    n_diverge = 0
    if verbose:
        log.info(f"spotless iter {iter0}: peak residual = {rmax:.3e}, "
              f"rms = {rms:.3e}")

    # exact-residual operator built once (one plan per dataset reused
    # across major iterations; reference spotless.py:186-190)
    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            backend=backend, epsilon=epsilon,
                            do_wgridding=do_wgridding)

    # one fused program per reweight phase: PD iteration + in-loop
    # reweight, with PSFHAT, data and weights as arguments
    pd_solve = make_primal_dual_fused(
        psf_convolve.apply, psiH, psiF, nbasis, rmsfactor, alpha=alpha,
        tol=pd_tol, maxit=pd_maxit, positivity=positivity, gamma=gamma,
        verbosity=pd_verbose, report_freq=pd_report_freq)

    dual_j = jnp.asarray(dual)
    for k in range(iter0, iter0 + niter):
        modelp = model.copy()
        data = jnp.asarray(residual) + psf_convolve(jnp.asarray(model))

        rf = init_factor * rmsfactor if k == iter0 else rmsfactor
        do_rw = k + 1 - iter0 >= l1reweight_from
        rc = jnp.asarray(rms_comps) if do_rw else \
            jnp.ones((1, 1, 1), dirty.dtype)
        model_j, dual_j, l1weight, pd_iters = pd_solve(
            jnp.asarray(model), dual_j, data, l1weight,
            jnp.asarray(rf * rms, dirty.dtype),
            jnp.asarray(hessnorm, dirty.dtype), rc, psf_convolve.consts,
            do_reweight=do_rw)
        model = np.asarray(model_j)

        conv = np.asarray(hess(model_j))
        residual = dirty - conv
        residual_mfs = residual.sum(axis=0)

        rmsp = rms
        rms = np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        eps = np.linalg.norm(model - modelp) / np.linalg.norm(model)
        if rms < best_rms:
            best_rms, best_rmax = rms, rmax
            best_model = model.copy()

        if verbose:
            log.info(f"spotless iter {k + 1}: peak residual = {rmax:.3e}, "
                  f"rms = {rms:.3e}, eps = {eps:.3e} "
                  f"(pd iters {int(pd_iters)})")

        if do_rw:
            rms_comps = coeff_rms(residual)

        if write and dds_name is not None:
            dual_np = np.asarray(dual_j)
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "DUAL": dual_np[b],
                          "MODEL_BEST": best_model[b]}
                if i == 0:
                    arrays["L1WEIGHT"] = np.asarray(l1weight)
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"spotless: converged after {k + 1} iterations")
            break
        if rms > rmsp:
            n_diverge += 1
            if n_diverge > diverge_count:
                log.info("spotless: algorithm diverging, terminating")
                break

    # fits products (reference spotless.py dds2fits_mfs/dds2fits calls)
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


def _spotless_dist(mesh=None, ddsi=None, output_filename=None,
                   product="I", suffix="main", nband=None, niter=5,
                   tol=5e-4, rmsfactor=1.0, init_factor=0.5, gamma=1.0,
                   bases="self,db1,db2", nlevels=3, l1reweight_from=5,
                   alpha=4.0, hessnorm=None, pm_tol=1e-5, pm_maxit=100,
                   pd_tol=1e-5, pd_maxit=500, positivity=1,
                   epsilon=1e-7, do_wgridding=True,
                   backend=DEFAULT_BACKEND, space_shards=0,
                   write=True, verbose=1, **kw):
    """Mesh-resident spotless major cycle: the realisation of the
    reference's distributed design intent (pfb/workers/spotless.py:
    429-667, commented out upstream) as ONE SPMD program family.

    Band-sharded DIRTY/MODEL/DUAL/RESIDUAL cubes stay device-resident
    across major iterations; the PSF-Hessian data step, the primal-dual
    backward step (with in-loop l1-reweight restart), the coefficient
    rms and the exact vis-space residual all run under shard_map over
    the 'band' mesh axis, communicating only through psums of scalars
    and (nbasis, Nymax, Nxmax) coefficient band-sums. L1WEIGHT is
    persisted for resume (reference spotless.py:536-546).

    Every per-shard PSF-Hessian matvec (power method, primal-dual
    gradient, data step) is the XLA rFFT convolve on the shard's own
    bands, and the exact vis-space residual runs each band's planned
    gridder on the card that holds the band
    (parallel.dist.make_hessian_dds_dist) — the reference's
    each-actor-holds-the-fast-operator design (spotless.py:429-667 +
    hessian.py:129-158) on the mesh.

    space_shards > 1 additionally shards the primal-dual backward step
    over a ('band', 'space') mesh: the DUAL cube — nbasis x the image
    cube, the object that outgrows one device's memory first —
    lives P('band', None, 'space', None) and the PD gradient runs the
    distributed-rFFT2 convolve (see
    parallel.dist.primal_dual_space_dist). The band-local steps
    (power method, data step, exact residual) replicate across the
    space axis of each band row.
    """
    import jax
    import jax.numpy as jnp
    from pfb_tpu.parallel.dist import (coeff_rms_dist, hessian_psf_dist,
                                       make_hessian_dds_dist,
                                       power_method_dist,
                                       prep_psfhat_space,
                                       primal_dual_dist,
                                       primal_dual_space_dist)
    from pfb_tpu.parallel.mesh import (band_sharding, coeff_sharding,
                                       make_mesh, replicated)

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

    if mesh is None:
        mesh = make_mesh(nspace=int(space_shards) or 1)
    elif space_shards and mesh.shape["space"] != int(space_shards):
        raise ValueError(
            f"explicit mesh has space axis {mesh.shape['space']} but "
            f"space_shards={space_shards} was also given — drop one")
    nb_mesh = mesh.shape["band"]
    nspace = mesh.shape["space"]
    assert nband % nb_mesh == 0, \
        f"nband {nband} not divisible by mesh band axis {nb_mesh}"
    if nspace > 1:
        assert nx % nspace == 0, \
            f"nx {nx} not divisible by mesh space axis {nspace}"

    dirty, model, residual, psf, psfhat, beam, wsums, dual = dds2cubes(
        dds, nband, apparent=False)
    wsum = wsums.sum()
    psf_mfs = psf.sum(axis=0)
    if residual is None:
        residual = dirty.copy()
    iter0 = int(dds[0].get("niters", 0))

    bands = band_sharding(mesh)
    coeffs = coeff_sharding(mesh)
    repl = replicated(mesh)
    bandv = jax.NamedSharding(
        mesh, jax.sharding.PartitionSpec("band"))

    dirty_d = jax.device_put(jnp.asarray(dirty), bands)
    model_d = jax.device_put(jnp.asarray(model), bands)
    resid_d = jax.device_put(jnp.asarray(residual), bands)

    ekw = dict(lastsize=ny_psf)
    hargs = (jax.device_put(jnp.asarray(psfhat), bands),)

    psf_convolve = hessian_psf_dist(mesh, **ekw)
    if hessnorm is None:
        pm = power_method_dist(mesh, tol=pm_tol, maxit=pm_maxit,
                               **ekw)
        b0 = jax.device_put(
            jnp.asarray(np.random.default_rng(42).normal(
                size=(nband, nx, ny)).astype(dirty.dtype)), bands)
        beta, _ = pm(b0, *hargs)
        hessnorm = float(beta) * 1.05  # reference spotless.py:193
    if verbose:
        log.info(f"spotless-dist: hessnorm = {hessnorm:.3e}")

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)

    GaussPar = fitcleanbeam(psf_mfs[None], level=0.5, pixsize=1.0)[0]
    pix_per_beam = GaussPar[0] * GaussPar[1] * np.pi / 4

    # per-band wsum weighting for the coefficient rms
    fsel = wsums > 0
    bandw = np.ones(nband, dirty.dtype)  # empty bands pass through
    bandw[fsel] = wsum / wsums[fsel]
    bandw_d = jax.device_put(jnp.asarray(bandw), bandv)
    coeff_rms = coeff_rms_dist(mesh, psi, pix_per_beam)
    rms_comps = np.asarray(coeff_rms(resid_d, bandw_d))[:, None, None]

    if dual is None or dual.shape[1] != nbasis:
        dual = np.zeros((nband, nbasis, psi.Nymax, psi.Nxmax),
                        dirty.dtype)
    dual_d = jax.device_put(jnp.asarray(dual), coeffs)
    if "L1WEIGHT" in dds[0]:
        l1weight = np.asarray(dds[0]["L1WEIGHT"], dirty.dtype)
    else:
        l1weight = np.ones((nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)
    l1w_d = jax.device_put(jnp.asarray(l1weight), repl)

    if nspace > 1:
        # PD backward step over ('band','space'): sharded dual cube +
        # space-distributed rFFT2 gradient
        pd = primal_dual_space_dist(
            mesh, psi, ny_psf, nu=nbasis, tol=pd_tol, maxit=pd_maxit,
            positivity=positivity, gamma=gamma, rmsfactor=rmsfactor,
            alpha=alpha)
        pd_h = jax.device_put(
            prep_psfhat_space(jnp.asarray(psfhat), nspace),
            jax.NamedSharding(mesh, jax.sharding.PartitionSpec(
                "band", None, "space")))
    else:
        pd = primal_dual_dist(mesh, psi, nu=nbasis, tol=pd_tol,
                              maxit=pd_maxit, positivity=positivity,
                              gamma=gamma, rmsfactor=rmsfactor,
                              alpha=alpha, **ekw)
        pd_h = hargs
    hess_exact = make_hessian_dds_dist(mesh, dds, nband, wsum, nx, ny,
                                       use_beam=False, backend=backend,
                                       epsilon=epsilon,
                                       do_wgridding=do_wgridding)

    residual_mfs = np.asarray(jnp.sum(resid_d, axis=0))
    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = np.asarray(model_d)
    diverge_count = 0
    if verbose:
        log.info(f"spotless-dist iter {iter0}: peak residual = "
                 f"{rmax:.3e}, rms = {rms:.3e}")

    for k in range(iter0, iter0 + niter):
        modelp = np.asarray(model_d)
        data = resid_d + psf_convolve(model_d, *hargs)

        rf = init_factor * rmsfactor if k == iter0 else rmsfactor
        do_rw = k + 1 - iter0 >= l1reweight_from
        rms_comps_d = jax.device_put(
            jnp.asarray(rms_comps[:, 0, 0][:, None, None] *
                        np.ones((1, psi.Nymax, psi.Nxmax),
                                dirty.dtype)), repl) if do_rw else None

        model_d, dual_d, l1w_d, pd_iters = pd(
            model_d, dual_d, data, pd_h, l1w_d,
            jnp.asarray(rf * rms, dirty.dtype),
            jnp.asarray(hessnorm, dirty.dtype),
            rms_comps=rms_comps_d, do_reweight=do_rw)

        conv = hess_exact(model_d)
        resid_d = dirty_d - conv
        residual_mfs = np.asarray(jnp.sum(resid_d, axis=0))

        rmsp = rms
        rms = np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        model = np.asarray(model_d)
        eps = np.linalg.norm(model - modelp) / np.linalg.norm(model)
        if rms < best_rms:
            best_rms, best_rmax = rms, rmax
            best_model = model.copy()

        if verbose:
            log.info(f"spotless-dist iter {k + 1}: peak residual = "
                     f"{rmax:.3e}, rms = {rms:.3e}, eps = {eps:.3e} "
                     f"(pd iters {int(pd_iters)})")

        if do_rw:
            rms_comps = np.asarray(coeff_rms(resid_d,
                                             bandw_d))[:, None, None]

        if write and dds_name is not None:
            dual_np = np.asarray(dual_d)
            residual = np.asarray(resid_d)
            l1w_np = np.asarray(l1w_d)
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "DUAL": dual_np[b],
                          "MODEL_BEST": best_model[b]}
                if i == 0:
                    arrays["L1WEIGHT"] = l1w_np
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"spotless-dist: converged after {k + 1} "
                         "iterations")
            break
        if rms > rmsp:
            diverge_count += 1
            if diverge_count > 3:
                log.info("spotless-dist: algorithm diverging, "
                         "terminating")
                break

    return np.asarray(model_d), np.asarray(resid_d)
