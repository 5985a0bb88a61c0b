"""Hogbom and Clark CLEAN tests: both must recover point-source fluxes
through a synthetic PSF to within the flux tolerance regime of the
upstream klean test (atol = 5*threshold, test_klean.py:257-260)."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.deconv.clark import clark
from pfb_tpu.deconv.hogbom import hogbom
from pfb_tpu.ops.fft import make_psfhat


def _make_problem(nband=2, nx=64, ny=64, nsource=5, seed=0):
    """Dirty image = PSF conv model, with a realistic-ish sidelobed PSF
    (sinc-damped cosine), normalised so the MFS PSF peak is 1."""
    rng = np.random.default_rng(seed)
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    r = np.sqrt(xx**2 + yy**2)
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        # sharp main lobe (~1 px, like an srf=2 interferometric PSF)
        # plus damped-cosine sidelobes
        s = 0.6 + 0.1 * b
        psf[b] = (np.exp(-0.5 * r**2 / s**2) +
                  0.08 * np.cos(r / 2.0) * np.exp(-r / 15.0)) / nband
    # normalise MFS peak to 1 (clark assumes wsum == 1, clark.py:101-102)
    peak = psf.sum(axis=0)[nxp // 2, nyp // 2]
    psf /= peak

    model = np.zeros((nband, nx, ny))
    for _ in range(nsource):
        i, j = rng.integers(8, nx - 8), rng.integers(8, ny - 8)
        flux = 1.0 + rng.random()
        model[:, i, j] = flux * (1.0 + 0.1 * np.arange(nband))

    psfhat = make_psfhat(jnp.asarray(psf))
    # dirty via the same padded-FFT convolution the deconvolvers use
    from pfb_tpu.ops.fft import psf_convolve_cube
    dirty = np.asarray(psf_convolve_cube(jnp.asarray(model), psfhat, nyp))
    wsums = psf.max(axis=(1, 2))
    return model, dirty, psf, np.asarray(psfhat), wsums


def test_hogbom_recovers_fluxes():
    model, dirty, psf, psfhat, wsums = _make_problem()
    x, IR, status = hogbom(jnp.asarray(dirty), jnp.asarray(psf),
                           threshold=1e-4, gamma=0.1, pf=1e-5,
                           maxit=10000)
    x = np.asarray(x)
    src = np.argwhere(model[0] > 0)
    for i, j in src:
        assert_allclose(x[:, i, j], model[:, i, j], atol=5e-3)
    # residual went down substantially
    assert np.abs(np.asarray(IR)).max() < 0.05 * np.abs(dirty).max()


def test_clark_recovers_fluxes():
    model, dirty, psf, psfhat, wsums = _make_problem(seed=1)
    x, IR, status = clark(jnp.asarray(dirty), jnp.asarray(psf),
                          jnp.asarray(psfhat), jnp.asarray(wsums),
                          threshold=1e-4, gamma=0.1, pf=1e-5,
                          maxit=50, subpf=0.5, submaxit=2000)
    x = np.asarray(x)
    src = np.argwhere(model[0] > 0)
    for i, j in src:
        assert_allclose(x[:, i, j], model[:, i, j], atol=5e-3)
    assert np.abs(np.asarray(IR)).max() < 0.05 * np.abs(dirty).max()


def test_hogbom_status_flags_maxit():
    model, dirty, psf, psfhat, wsums = _make_problem(seed=2)
    x, IR, status = hogbom(jnp.asarray(dirty), jnp.asarray(psf),
                           threshold=0.0, gamma=0.05, pf=1e-8, maxit=3)
    assert int(status) == 1


@pytest.mark.parametrize("nband", [4, 8])
def test_clark_many_bands_recovers_fluxes(nband):
    """With wsums ~ 1/nband per band, every subminor subtraction must
    match the flux the model gains (a subtraction short by wsums makes
    the outer exact convolution overshoot, and klean diverged at 8
    bands)."""
    model, dirty, psf, psfhat, wsums = _make_problem(nband=nband, seed=3)
    x, IR, status = clark(jnp.asarray(dirty), jnp.asarray(psf),
                          jnp.asarray(psfhat), jnp.asarray(wsums),
                          threshold=1e-4, gamma=0.1, pf=1e-5,
                          maxit=30, subpf=0.5, submaxit=2000)
    x = np.asarray(x)
    for i, j in np.argwhere(model[0] > 0):
        assert_allclose(x[:, i, j], model[:, i, j], atol=5e-3)
    assert np.abs(np.asarray(IR)).max() < 0.05 * np.abs(dirty).max()
