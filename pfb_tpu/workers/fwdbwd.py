"""fwdbwd worker: generalised forward-backward with a nonlinear model
parametrisation x = f(s).

Working JAX implementation of the reference's design intent
(pfb/workers/fwdbwd.py:23-474 — broken upstream: it imports a removed
wavelet API at fwdbwd.py:85,181 and ships a live ipdb.set_trace at
:236; SURVEY.md pitfalls). Per major iteration:

  1. linearised Hessian H_s(v) = 2 dF.H(PSF(dF v)) + sigmainv v around
     the current parameter s (fwdbwd.py:297-299)
  2. power method on H_s for the step size (warm-started)
  3. PCG forward step: H_s delx = dF.H(2 residual)
  4. mode-removal trick for non-identity parametrisations
     (fwdbwd.py:353-364)
  5. primal-dual backward step toward s + gamma delx with the SARA l21
     prior
  6. model = f(s), exact residual, PARAM/MODEL/DUAL/RESIDUAL writeback.

Parametrisations (reference setup_parametrisation,
pfb/utils/misc.py:1378-1423): 'id' — frequency-correlated linear model
x = L s (L the Cholesky factor of a squared-exponential band
covariance); 'exp' — correlated log-normal x = exp(L s).
"""

from functools import partial

import numpy as np

from pfb_tpu.ops.gridder import DEFAULT_BACKEND, make_hessian_dds
from pfb_tpu.ops.psf import make_psf_convolve
from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu.opt.pcg import pcg
from pfb_tpu.opt.power_method import power_method
from pfb_tpu.opt.primal_dual import primal_dual
from pfb_tpu.utils import dstore
from pfb_tpu.utils.logging import get_logger
from pfb_tpu.workers.cubes import dds2cubes


def setup_parametrisation(mode="id", minval=1e-5, sigma=1.0, freq=None,
                          lscale=1.0):
    """(func, finv, dfunc, dhfunc) for x = f(s)
    (reference: pfb/utils/misc.py:1378-1423). All jnp-traceable."""
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular

    nu = freq / np.mean(freq)
    nband = nu.size
    nudiffsq = (nu[:, None] - nu[None, :]) ** 2
    K = sigma**2 * np.exp(-nudiffsq / (2 * lscale**2))
    L = jnp.asarray(np.linalg.cholesky(K + 1e-10 * np.eye(nband)))

    def freqmul(A, x):
        return jnp.einsum("ab,bxy->axy", A, x)

    if mode == "id":
        func = lambda x: freqmul(L, x)
        finv = lambda x: solve_triangular(
            L, x.reshape(nband, -1), lower=True).reshape(x.shape)
        dfunc = lambda x0, v: freqmul(L, v)
        dhfunc = lambda x0, v: freqmul(L.T, v)
    elif mode == "exp":
        func = lambda x: jnp.exp(freqmul(L, x))
        def finv(x):
            tmp = solve_triangular(L, x.reshape(nband, -1),
                                   lower=True).reshape(x.shape)
            return jnp.log(jnp.maximum(jnp.abs(tmp), minval))
        dfunc = lambda x0, v: jnp.exp(freqmul(L, x0)) * freqmul(L, v)
        dhfunc = lambda x0, v: freqmul(L.T, v * jnp.exp(freqmul(L, x0)))
    else:
        raise ValueError(f"Unknown parametrisation {mode}")
    return func, finv, dfunc, dhfunc


log = get_logger("FWDBWD")


def _fwdbwd(ddsi=None, output_filename=None, product="I",
            suffix="main", nband=None, niter=5, tol=5e-4,
            parametrisation="id", sigmainv=1e-5, sigma21=None,
            rmsfactor=1.0, gamma=1.0, bases="self,db1,db2", nlevels=2,
            l1reweight_from=5, pm_tol=1e-4, pm_maxit=100,
            pm_verbose=0, pm_report_freq=100, cg_tol=1e-4,
            cg_maxit=100, cg_minit=5, cg_verbose=0, cg_report_freq=10,
            backtrack=True, pd_tol=1e-4, pd_maxit=300, pd_verbose=0,
            pd_report_freq=50, positivity=0, backend=DEFAULT_BACKEND,
            epsilon=1e-7, do_wgridding=True, mask=None,
            model_name="MODEL", write=True, verbose=1,
            fits_mfs=False, fits_cubes=False, restart=False, **kw):
    """Returns (model, param, residual)."""
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

    mask_im = None
    if mask is not None:
        mask_im = (np.any(model > 0, axis=0) if mask == "model"
                   else np.asarray(mask)).astype(dirty.dtype)

    # exact-residual operator built once (one compiled program)
    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            backend=backend, epsilon=epsilon,
                            do_wgridding=do_wgridding)
    lastsize = dds[0]["PSF"].shape[-1]

    psf_convolve = make_psf_convolve(jnp.asarray(psfhat), lastsize)

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)
    psiH = partial(psi_dot, psi=psi)
    psiF = partial(psi_hdot, psi=psi)

    # Psi Psi.H spectral norm (reference fwdbwd.py:247-259)
    psinorm, _ = power_method(lambda v: psiF(psiH(v)),
                              (nband, nx, ny), tol=pm_tol,
                              maxit=pm_maxit, dtype=dirty.dtype,
                              verbosity=pm_verbose,
                              report_freq=pm_report_freq)
    psinorm = float(psinorm)

    minval = float(np.median(model[model > 0])) if model.any() else 1e-5
    func, finv, dfunc, dhfunc = setup_parametrisation(
        mode=parametrisation, minval=minval, freq=freqs_out)

    # initialise PARAM (reference fwdbwd.py:300-....)
    if "PARAM" in dds[0] and \
            dds[0].get("parametrisation") == parametrisation and \
            not restart:
        x = np.stack([ds["PARAM"] for ds in
                      sorted(dds, key=lambda d: d["bandid"])])
    elif model.any() and not restart:
        x = np.asarray(finv(jnp.asarray(model)))
        model = np.asarray(func(jnp.asarray(x)))
        residual = dirty - np.asarray(hess(jnp.asarray(model)))
    else:
        x = np.zeros_like(dirty)
        model = np.asarray(func(jnp.asarray(x)))
        residual = dirty.copy()

    dual = jnp.zeros((nband, nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)
    l1weight = jnp.ones((nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)

    hessbeta = None
    residual_mfs = residual.sum(axis=0)
    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    if verbose:
        log.info(f"fwdbwd iter 0: peak residual = {rmax:.3e}, "
              f"rms = {rms:.3e}")

    for k in range(niter):
        xp = jnp.asarray(x)
        df = partial(dfunc, xp)
        dhf = partial(dhfunc, xp)
        res_in = residual if mask_im is None else \
            residual * mask_im[None]
        j = np.asarray(dhf(2.0 * jnp.asarray(res_in)))
        sigmainv_k = max(float(np.std(j)), sigmainv)

        def hesspsf(v):
            return 2.0 * dhf(psf_convolve(df(v))) + v * sigmainv_k

        hessnorm, hessbeta = power_method(
            hesspsf, (nband, nx, ny), b0=hessbeta, tol=pm_tol,
            maxit=pm_maxit, dtype=dirty.dtype, verbosity=pm_verbose,
            report_freq=pm_report_freq)
        hessnorm = float(hessnorm)

        delx = pcg(hesspsf, jnp.asarray(j), tol=cg_tol, maxit=cg_maxit,
                   minit=cg_minit, backtrack=backtrack,
                   verbosity=cg_verbose, report_freq=cg_report_freq)

        # threshold scale (reference fwdbwd.py:339-348)
        tmpx = np.random.default_rng(k).standard_normal(dirty.shape)
        rscale = float(np.std(np.asarray(hesspsf(jnp.asarray(tmpx)))))
        sig21 = rmsfactor * float(np.std(j / rscale)) \
            if sigma21 is None else sigma21

        if sig21:
            data = xp + gamma * delx
            dmode = 0.0
            if parametrisation != "id":
                ref_arr = np.asarray(xp) if np.asarray(xp).any() else \
                    np.asarray(data)
                bedges = np.histogram_bin_edges(ref_arr.ravel(),
                                                bins="fd")
                dhist, _ = np.histogram(np.asarray(data).ravel(),
                                        bins=bedges)
                dmode = float(bedges[dhist.argmax()])
                data = data - dmode
                xp = xp - dmode

            def grad21(v, data=data):
                return hesspsf(v - data)

            xn, dual, l1weight, _ = primal_dual(
                xp, dual, sig21, psiH, psiF, hessnorm, l1weight,
                grad21, nu=psinorm, tol=pd_tol, maxit=pd_maxit,
                positivity=positivity, gamma=gamma,
                verbosity=pd_verbose, report_freq=pd_report_freq)
            x = np.asarray(xn) + dmode
        else:
            x = np.asarray(xp + gamma * delx)

        model = np.asarray(func(jnp.asarray(x)))
        residual = dirty - np.asarray(hess(jnp.asarray(model)))
        residual_mfs = residual.sum(axis=0)
        rms = np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        eps = np.linalg.norm(x - np.asarray(xp)) / np.linalg.norm(x)
        if verbose:
            log.info(f"fwdbwd iter {k + 1}: peak residual = {rmax:.3e}, "
                  f"rms = {rms:.3e}, eps = {eps:.3e}")

        if write and dds_name is not None:
            dual_np = np.asarray(dual)
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b], "DUAL": dual_np[b],
                          "PARAM": x[b]}
                attrs = {"parametrisation": parametrisation}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"fwdbwd: converged after {k + 1} iterations")
            break

    # fits products (reference fwdbwd.py fits-mfs/fits-cubes options)
    if (fits_mfs or fits_cubes) and output_filename is not None:
        from pfb_tpu.utils.fits import dds2fits, dds2fits_mfs
        base = f"{output_filename}_{product.upper()}_{suffix}"
        for col, norm in (("RESIDUAL", True), ("MODEL", False)):
            if fits_mfs:
                dds2fits_mfs(dds, col, base, norm_wsum=norm)
            if fits_cubes:
                dds2fits(dds, col, base, norm_wsum=norm)

    return model, x, residual
