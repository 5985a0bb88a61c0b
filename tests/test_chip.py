"""Parity of the compiled kernels on the GPU at real widths, float32 on
the card against a float64 host reference.

Run on the card with ``pytest -m chip tests/test_chip.py`` (or through
chip_smoke.py); without a GPU every test skips. The tolerances, and why:

- XLA PSF convolve, one band at 4096^2 (8192^2 padded), vs numpy f64
  FFT: max-rel <= 1e-5 (f32 FFT error grows with log2 N).
- The chosen gridder, adjoint and forward at 4096^2, epsilon 1e-5, w
  on, on a 4096-row subset of the chip_smoke deployment, vs the exact
  f64 direct transform: max-rel <= 1e-4 (10 x epsilon covers the f32
  accumulation; a TF32 product fails it).
- Psi Psi^H at 4096^2, self,db1,db2, 3 levels: nbasis x identity to
  <= 1e-5 relative (an f32 round trip).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.chip

NX = 4096


def _deployment_subset(nrow=4096, seed=0):
    """A random nrow-row subset of the chip_smoke deployment's uv
    coverage (64 antennas, 500 times, 8 channels) and its cell."""
    from pfb_tpu.ops.dft import LIGHTSPEED
    from pfb_tpu.utils.simulation import simulate_obs
    obs = simulate_obs(nant=64, ntime=500, nchan=8, extent=4000.0,
                       seed=420)
    uv_max = np.abs(obs.uvw[:, :2]).max()
    cell = 1.0 / (2 * uv_max * obs.freq.max() / LIGHTSPEED) / 2.0
    rows = np.sort(np.random.default_rng(seed).choice(
        obs.uvw.shape[0], nrow, replace=False))
    return obs.uvw[rows], obs.freq, cell


def _lmn(ix, iy, nx, cell):
    l = (ix - nx // 2) * cell
    m = (iy - nx // 2) * cell
    eps = l**2 + m**2
    return l, m, -eps / (np.sqrt(1.0 - eps) + 1.0)


def _maxrel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_psf_convolve_4096(gpu):
    import jax.numpy as jnp

    from pfb_tpu.ops.fft import make_psfhat
    from pfb_tpu.ops.psf import make_psf_convolve

    nxp = 2 * NX
    rng = np.random.default_rng(1)
    xg = np.arange(nxp) - NX
    psf = np.exp(-0.5 * (xg[:, None]**2 + xg[None, :]**2) / 9.0)
    psf[NX + 5, NX - 3] += 0.1  # uneven: a complex transfer function
    x = rng.normal(size=(NX, NX))
    psfhat = make_psfhat(jnp.asarray(psf[None], jnp.float32))
    got = np.asarray(make_psf_convolve(psfhat, nxp)(
        jnp.asarray(x[None], jnp.float32))[0], np.float64)
    ph = np.fft.rfft2(np.fft.ifftshift(psf))
    xp = np.zeros((nxp, nxp))
    xp[:NX, :NX] = x
    ref = np.fft.irfft2(np.fft.rfft2(xp) * ph, s=(nxp, nxp))[:NX, :NX]
    err = _maxrel(got, ref)
    print(f"psf convolve 4096^2 f32 vs f64: max-rel {err:.2e}")
    assert err <= 1e-5


@pytest.fixture(scope="module")
def subset():
    return _deployment_subset()


def test_gridder_adjoint_4096(gpu, subset):
    import jax.numpy as jnp

    from pfb_tpu.ops.dft import LIGHTSPEED
    from pfb_tpu.ops.gridder import DEFAULT_BACKEND, Gridder
    from pfb_tpu.utils.ms import point_source_vis

    uvw, freq, cell = subset
    rng = np.random.default_rng(2)
    cube = np.zeros((freq.size, NX, NX))
    src = rng.integers(NX // 8, 7 * NX // 8, size=(3, 2))
    for s, (i, j) in enumerate(src):
        cube[:, i, j] = 1.0 + s
    vis = point_source_vis(uvw, freq, cube, cell)
    wgt = rng.random(vis.shape)
    g = Gridder(DEFAULT_BACKEND, uvw, freq, nx=NX, ny=NX, cell=cell,
                epsilon=1e-5, do_wgridding=True)
    got = np.asarray(g.vis2dirty(
        (jnp.asarray(vis.real, jnp.float32),
         jnp.asarray(vis.imag, jnp.float32)),
        wgt=jnp.asarray(wgt, jnp.float32)), np.float64)
    # exact f64 adjoint at the sources and 4093 random pixels
    pix = np.concatenate([src, rng.integers(0, NX, size=(4093, 2))])
    l, m, n1 = _lmn(pix[:, 0], pix[:, 1], NX, cell)
    ref = np.zeros(len(pix))
    for c in range(freq.size):
        cyc = (uvw[:, 0:1] * l + uvw[:, 1:2] * m + uvw[:, 2:3] * n1) \
            * (freq[c] / LIGHTSPEED)
        ref += np.real((wgt[:, c] * vis[:, c]) @ np.exp(2j * np.pi * cyc))
    err = _maxrel(got[pix[:, 0], pix[:, 1]], ref)
    print(f"{DEFAULT_BACKEND} adjoint 4096^2 eps 1e-5 vs f64 DFT: "
          f"max-rel {err:.2e}")
    assert err <= 1e-4


def test_gridder_forward_4096(gpu, subset):
    import jax.numpy as jnp

    from pfb_tpu.ops.gridder import DEFAULT_BACKEND, Gridder
    from pfb_tpu.utils.ms import point_source_vis

    uvw, freq, cell = subset
    rng = np.random.default_rng(3)
    img = np.zeros((NX, NX))
    pix = rng.integers(0, NX, size=(64, 2))
    img[pix[:, 0], pix[:, 1]] = rng.normal(size=64)
    g = Gridder(DEFAULT_BACKEND, uvw, freq, nx=NX, ny=NX, cell=cell,
                epsilon=1e-5, do_wgridding=True)
    got = np.asarray(g.dirty2vis(jnp.asarray(img, jnp.float32)))
    ref = point_source_vis(uvw, freq,
                           np.broadcast_to(img, (freq.size, NX, NX)),
                           cell)
    err = _maxrel(got, ref)
    print(f"{DEFAULT_BACKEND} forward 4096^2 eps 1e-5 vs f64 direct: "
          f"max-rel {err:.2e}")
    assert err <= 1e-4


def test_psi_roundtrip_4096(gpu):
    import jax.numpy as jnp

    from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot

    bases = ("self", "db1", "db2")
    psi = make_psi(NX, NX, bases, 3)
    x = np.random.default_rng(4).normal(size=(1, NX, NX))
    got = np.asarray(psi_hdot(psi_dot(jnp.asarray(x, jnp.float32), psi),
                              psi), np.float64)
    err = _maxrel(got, len(bases) * x)
    print(f"Psi Psi^H 4096^2 f32: max-rel {err:.2e}")
    assert err <= 1e-5
