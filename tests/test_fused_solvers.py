"""Fused solver factories (jit with operator constants as arguments,
make_psf_convolve's .apply/.consts hooks): exact parity with the eager
solvers."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax.numpy as jnp

from pfb_tpu.ops.fft import make_psfhat
from pfb_tpu.ops.psf import hessian_psf_cube, make_psf_convolve


def _setup(nband=2, nx=32, seed=5):
    rng = np.random.default_rng(seed)
    xg = np.arange(2 * nx) - nx
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    psf = np.zeros((nband, 2 * nx, 2 * nx))
    for b in range(nband):
        psf[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (2.0 + b) ** 2)
        psf[b, nx, nx] += 0.6
    psfhat = make_psfhat(jnp.asarray(psf))
    model = np.zeros((nband, nx, nx))
    model[:, nx // 3, nx // 2] = 1.0
    model[:, 2 * nx // 3, nx // 4] = 0.5
    return psf, psfhat, jnp.asarray(model)


def _apply(x, consts):
    return hessian_psf_cube(x, consts["psfhat"],
                            lastsize=consts["psfhat"].shape[-2],
                            sigmainv=1e-3)


def test_pcg_bands_fused_matches_eager():
    from pfb_tpu.opt.pcg import make_pcg_bands_fused, pcg_bands
    psf, psfhat, model = _setup()
    hess = make_psf_convolve(psfhat, 2 * psf.shape[-1] // 2,
                             sigmainv=1e-3)
    b = hess(model)
    consts = {"psfhat": psfhat}
    x1 = np.asarray(pcg_bands(lambda z: _apply(z, consts), b,
                              tol=1e-10, maxit=60, minit=10,
                              backtrack=False))
    solve = make_pcg_bands_fused(_apply, tol=1e-10, maxit=60,
                                 minit=10, backtrack=False)
    x2 = np.asarray(solve(b, jnp.zeros_like(b), consts))
    # jit whole-program fusion reorders f64 reductions vs the eager
    # op-by-op path; 1e-9 on a unit-scale solution is fusion noise
    # headroom only, not a semantic tolerance
    assert_allclose(x1, x2, atol=1e-9)


def test_power_method_fused_matches_eager():
    import jax

    from pfb_tpu.opt.power_method import (make_power_method_fused,
                                          power_method)
    psf, psfhat, model = _setup(seed=7)
    consts = {"psfhat": psfhat}
    b0 = jax.random.normal(jax.random.PRNGKey(42), model.shape,
                           model.dtype)
    beta1, _ = power_method(lambda z: _apply(z, consts), model.shape,
                            b0=b0, tol=1e-8, maxit=100,
                            dtype=model.dtype)
    pm = make_power_method_fused(_apply, tol=1e-8, maxit=100)
    beta2, _ = pm(b0, consts)
    assert_allclose(float(beta1), float(beta2), rtol=1e-12)


@pytest.mark.parametrize("do_rw", [False, True])
def test_primal_dual_fused_matches_eager(do_rw):
    from functools import partial

    from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
    from pfb_tpu.opt.primal_dual import (make_primal_dual_fused,
                                         primal_dual)
    psf, psfhat, model = _setup(seed=9)
    nband, nx, ny = model.shape
    bases = ("self", "db1")
    psi = make_psi(nx, ny, bases, 2)
    psiH = partial(psi_dot, psi=psi)
    psiF = partial(psi_hdot, psi=psi)
    nbasis = len(bases)

    consts = {"psfhat": psfhat}
    data = _apply(model, consts)
    l1w = jnp.ones((nbasis, psi.Nymax, psi.Nxmax), model.dtype)
    v0 = jnp.zeros((nband, nbasis, psi.Nymax, psi.Nxmax), model.dtype)
    L, lam, rmsfactor, alpha = 2.0, 1e-3, 1.5, 4.0
    rms_comps = jnp.full((nbasis, 1, 1), 0.1, model.dtype)

    def grad(z):
        return _apply(z, consts) - data

    if do_rw:
        def reweighter(z):
            mcomps = jnp.abs(jnp.sum(psiH(z), axis=0))
            return (1 + rmsfactor) / \
                (1 + mcomps**alpha / rms_comps**alpha)
    else:
        reweighter = None

    x1, v1, w1, k1 = primal_dual(
        jnp.zeros_like(model), v0, lam, psiH, psiF, L, l1w, grad,
        reweighter=reweighter, nu=nbasis, tol=1e-7, maxit=100,
        positivity=1, gamma=1.0)

    solve = make_primal_dual_fused(_apply, psiH, psiF, nbasis,
                                   rmsfactor, alpha=alpha, tol=1e-7,
                                   maxit=100, positivity=1, gamma=1.0)
    x2, v2, w2, k2 = solve(jnp.zeros_like(model), v0, data, l1w,
                           jnp.asarray(lam, model.dtype),
                           jnp.asarray(L, model.dtype), rms_comps,
                           consts, do_reweight=do_rw)

    assert int(k1) == int(k2)
    assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-12)
    assert_allclose(np.asarray(w1), np.asarray(w2), atol=1e-12)


@pytest.mark.parametrize("use_beam", [False, True])
@pytest.mark.parametrize("sigmainv,wsum", [(0.0, None), (1e-3, 2.5)])
def test_psf_convolve_hooks_match_matvec(use_beam, sigmainv, wsum):
    """matvec.apply(x, matvec.consts) is the same operator as
    matvec(x), for every beam / Tikhonov / wsum combination."""
    psf, psfhat, model = _setup(seed=13)
    beam = None
    if use_beam:
        nx = model.shape[-1]
        xg = (np.arange(nx) - nx // 2) / nx
        beam = jnp.asarray(np.exp(-(xg[:, None]**2 + xg[None, :]**2)))
    hess = make_psf_convolve(psfhat, psf.shape[-1], beam=beam,
                             sigmainv=sigmainv, wsum=wsum)
    assert hess.consts["psfhat"] is psfhat
    assert_allclose(np.asarray(hess.apply(model, hess.consts)),
                    np.asarray(hess(model)), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("solver", ["pcg", "pm", "pd"])
def test_fused_solvers_on_psf_convolve_hooks(solver):
    """The three fused solvers run on make_psf_convolve's .apply /
    .consts hooks (PSFHAT a jit argument) and agree with the eager
    solvers closing over the matvec."""
    import jax
    from functools import partial

    from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
    from pfb_tpu.opt.pcg import make_pcg_bands_fused, pcg_bands
    from pfb_tpu.opt.power_method import (make_power_method_fused,
                                          power_method)
    from pfb_tpu.opt.primal_dual import (make_primal_dual_fused,
                                         primal_dual)

    psf, psfhat, model = _setup(seed=17)
    hess = make_psf_convolve(psfhat, psf.shape[-1], sigmainv=1e-3)
    if solver == "pcg":
        b = hess(model)
        x1 = pcg_bands(hess, b, tol=1e-10, maxit=40, minit=5,
                       backtrack=False)
        solve = make_pcg_bands_fused(hess.apply, tol=1e-10, maxit=40,
                                     minit=5, backtrack=False)
        x2 = solve(b, jnp.zeros_like(b), hess.consts)
        assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-9)
    elif solver == "pm":
        b0 = jax.random.normal(jax.random.PRNGKey(1), model.shape,
                               model.dtype)
        beta1, _ = power_method(hess, model.shape, b0=b0, tol=1e-8,
                                maxit=100, dtype=model.dtype)
        pm = make_power_method_fused(hess.apply, tol=1e-8, maxit=100)
        beta2, _ = pm(b0, hess.consts)
        assert_allclose(float(beta1), float(beta2), rtol=1e-12)
    else:
        nband, nx, ny = model.shape
        psi = make_psi(nx, ny, ("self", "db1"), 2)
        psiH = partial(psi_dot, psi=psi)
        psiF = partial(psi_hdot, psi=psi)
        data = hess(model)
        l1w = jnp.ones((2, psi.Nymax, psi.Nxmax), model.dtype)
        v0 = jnp.zeros((nband, 2, psi.Nymax, psi.Nxmax), model.dtype)
        x1, _, _, k1 = primal_dual(
            jnp.zeros_like(model), v0, 1e-3, psiH, psiF, 2.0, l1w,
            lambda z: hess(z) - data, nu=2, tol=1e-7, maxit=60)
        solve = make_primal_dual_fused(hess.apply, psiH, psiF, 2, 1.0,
                                       tol=1e-7, maxit=60)
        x2, _, _, k2 = solve(jnp.zeros_like(model), v0, data, l1w,
                             jnp.asarray(1e-3, model.dtype),
                             jnp.asarray(2.0, model.dtype),
                             jnp.ones((1, 1, 1), model.dtype),
                             hess.consts)
        assert int(k1) == int(k2)
        assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-12)


def test_spotless_exact_residual_backends_agree(tmp_path):
    """spotless runs the fused PD on the XLA convolve; its exact
    vis-space residual through the planned 'wgrid' gridder matches the
    exact-DFT oracle's."""
    from pfb_tpu.utils.ms import simulate_ms
    from pfb_tpu.workers.grid import _grid
    from pfb_tpu.workers.init import _init
    from pfb_tpu.workers.spotless import _spotless

    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=7, ntime=4, nchan=2, nsource=1,
                fov_deg=0.2, seed=3, gains=False)
    out = str(tmp_path / "o")
    xds = _init(ms=ms, output_filename=out, channels_per_image=1)
    dds = _grid(xdsi=xds, output_filename=out, suffix="main",
                field_of_view=0.2, robustness=0.0, psf=True,
                residual=False, backend="dft")
    kw = dict(niter=2, rmsfactor=0.8, gamma=1.0, l1reweight_from=1,
              pd_maxit=50, verbose=0, write=False)
    model_d, resid_d = _spotless(ddsi=[dict(d) for d in dds],
                                 backend="dft", **kw)
    model_w, resid_w = _spotless(ddsi=[dict(d) for d in dds],
                                 backend="wgrid", epsilon=1e-9, **kw)
    assert np.abs(model_w).max() > 0
    denom = np.abs(resid_d).max()
    assert np.abs(resid_w - resid_d).max() / denom < 1e-6
    assert np.abs(model_w - model_d).max() / np.abs(model_d).max() \
        < 1e-6
