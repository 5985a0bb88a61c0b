"""Measurement operator tests: R/R.H adjointness, PSF normalisation,
uv-counts vs histogram (upstream tests/test_weighting.py:64-81), Briggs
weights, and dirty-image flux recovery at source pixels (upstream
test_polproducts.py semantics, rtol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.ops.dft import LIGHTSPEED, dirty2vis_dft, vis2dirty_dft
from pfb_tpu.ops.gridder import hessian_slice, image_data_products
from pfb_tpu.ops.weighting import compute_counts, counts_to_weights
from pfb_tpu.utils.simulation import (image_size_for, point_source_model,
                                      simulate_obs)


@pytest.fixture(scope="module")
def obs():
    return simulate_obs(nant=7, ntime=8, nchan=3, seed=1)


def test_adjointness(obs):
    """<R x, y> == <x, R.H y> with weights 1: the defining property the
    spotless residual-consistency test relies on
    (upstream test_spotless.py:322-325)."""
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(nx, nx))
    yr = rng.normal(size=(obs.uvw.shape[0], obs.freq.size))
    yi = rng.normal(size=yr.shape)
    y = yr + 1j * yi

    Rx = np.asarray(dirty2vis_dft(jnp.asarray(obs.uvw),
                                  jnp.asarray(obs.freq),
                                  jnp.asarray(x), cell, cell))
    RHy = np.asarray(vis2dirty_dft(jnp.asarray(obs.uvw),
                                   jnp.asarray(obs.freq),
                                   jnp.asarray(y), nx=nx, ny=nx,
                                   cellx=cell, celly=cell))
    # adjointness over the real inner product Re<a, b>:
    # Re<R x, y> = <x, R.H y> with the e^{-i}/e^{+i} kernel pair
    lhs = np.sum(Rx.real * yr + Rx.imag * yi)
    rhs = np.sum(x * RHy)
    assert_allclose(lhs, rhs, rtol=1e-10)


def test_psf_peak_equals_wsum(obs):
    """Gridding unit visibilities gives PSF with peak = wsum at centre."""
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    nrow, nchan = obs.uvw.shape[0], obs.freq.size
    vis = jnp.ones((nrow, nchan), jnp.complex128)
    wgt = jnp.asarray(np.random.default_rng(1).random((nrow, nchan)))
    psf = np.asarray(vis2dirty_dft(jnp.asarray(obs.uvw),
                                   jnp.asarray(obs.freq), vis, wgt=wgt,
                                   nx=nx, ny=nx, cellx=cell, celly=cell))
    assert_allclose(psf[nx // 2, nx // 2], float(wgt.sum()), rtol=1e-12)
    assert np.abs(psf).max() == psf[nx // 2, nx // 2]


def test_dirty_recovers_point_source_flux(obs):
    """Model vis of point sources -> weighted dirty/wsum recovers flux at
    the source pixel to ~1e-4 (upstream test_polproducts.py:265-269)."""
    nx, cell = image_size_for(obs, fov_deg=0.15)
    nx = min(nx, 128)
    # single source: with few synthetic baselines, multiple sources
    # contaminate each other through PSF sidelobes; one source makes the
    # pixel flux exact for the DFT path
    model, Ix, Iy = point_source_model(nx, nx, obs.freq, nsource=1,
                                       seed=2, margin=8)
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)
    nrow, nchan = obs.uvw.shape[0], obs.freq.size

    # per-channel degrid (each channel has its own model slice)
    vis = np.zeros((nrow, nchan), dtype=np.complex128)
    for c in range(nchan):
        vis[:, c:c + 1] = np.asarray(dirty2vis_dft(
            uvw, freq[c:c + 1], jnp.asarray(model[c]), cell, cell))

    # natural weights; normalise per channel
    for c in range(nchan):
        dirty = np.asarray(vis2dirty_dft(
            uvw, freq[c:c + 1], jnp.asarray(vis[:, c:c + 1]),
            nx=nx, ny=nx, cellx=cell, celly=cell))
        wsum = nrow
        # n-term correction (images are I/n, reference test_klean.py:252)
        l = (np.arange(nx) - nx // 2) * cell
        ll, mm = np.meshgrid(l, l, indexing="ij")
        eps = ll**2 + mm**2
        n = 1 - eps / (np.sqrt(1 - eps) + 1)
        for s in range(1):
            flux = dirty[Ix[s], Iy[s]] / wsum * n[Ix[s], Iy[s]]
            assert_allclose(flux, model[c, Ix[s], Iy[s]], rtol=2e-4)


def test_counts_vs_histogram(obs):
    """k=0 counts == np.histogram2d on the uv coordinates (upstream
    tests/test_weighting.py:64-81)."""
    nx = 64
    cell = 1.0 / (4 * np.abs(obs.uvw[:, :2]).max() * obs.freq.max()
                  / LIGHTSPEED)
    mask = np.ones((obs.uvw.shape[0], obs.freq.size), np.uint8)
    counts = np.asarray(compute_counts(
        jnp.asarray(obs.uvw), jnp.asarray(obs.freq), jnp.asarray(mask),
        nx, nx, cell, cell, k=0))

    u_cell = 1 / (nx * cell)
    umax = abs(-1 / cell / 2 - u_cell / 2)
    ulam = obs.uvw[:, 0:1] * obs.freq[None, :] / LIGHTSPEED
    vlam = obs.uvw[:, 1:2] * obs.freq[None, :] / LIGHTSPEED
    # histogram with the same binning
    edges = umax + u_cell * np.arange(nx + 1)
    hist, _, _ = np.histogram2d(ulam.ravel() + 2 * umax,
                                vlam.ravel() + 2 * umax,
                                bins=[edges, edges])
    assert_allclose(counts, hist)
    assert counts.sum() == obs.uvw.shape[0] * obs.freq.size


def test_briggs_weights_change_resolution(obs):
    nx = 64
    cell = 1.0 / (4 * np.abs(obs.uvw[:, :2]).max() * obs.freq.max()
                  / LIGHTSPEED)
    mask = np.ones((obs.uvw.shape[0], obs.freq.size), np.uint8)
    counts = compute_counts(jnp.asarray(obs.uvw), jnp.asarray(obs.freq),
                            jnp.asarray(mask), nx, nx, cell, cell, k=6)
    w_uniformish = np.asarray(counts_to_weights(
        counts, jnp.asarray(obs.uvw), jnp.asarray(obs.freq), nx, nx,
        cell, cell, -2.0))
    w_natural = np.asarray(counts_to_weights(
        counts, jnp.asarray(obs.uvw), jnp.asarray(obs.freq), nx, nx,
        cell, cell, 2.0))
    assert (w_uniformish > 0).all()
    # robust=+2 ~ natural: nearly flat; robust=-2 ~ uniform: 1/counts
    assert w_natural.std() / w_natural.mean() < \
        w_uniformish.std() / w_uniformish.mean()


def test_image_data_products_residual_consistency(obs):
    """residual(model) == dirty - hessian(model): R/R.H consistency, the
    core invariant of the major cycle (upstream test_spotless.py:322-325)."""
    nx, cell = image_size_for(obs, fov_deg=0.15)
    nx = min(nx, 64)
    model, _, _ = point_source_model(nx, nx, obs.freq[:1], nsource=2,
                                     seed=3, margin=8)
    model = model[0]
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq[:1])
    nrow = obs.uvw.shape[0]
    vis = dirty2vis_dft(uvw, freq, jnp.asarray(model), cell, cell)
    wgt = jnp.ones((nrow, 1))
    mask = jnp.ones((nrow, 1), jnp.uint8)

    out = image_data_products(uvw, freq, vis, wgt, mask, None,
                              nx, nx, 2 * nx, 2 * nx, cell, cell,
                              model=jnp.asarray(model) * 0.5)
    hess = hessian_slice(jnp.asarray(model) * 0.5, uvw, freq, wgt, mask,
                         cell, cell)
    assert_allclose(np.asarray(out["RESIDUAL"]),
                    np.asarray(out["DIRTY"]) - np.asarray(hess),
                    atol=1e-8)
    # PSF peak equals wsum
    assert_allclose(np.asarray(out["PSF"])[2 * nx // 2, 2 * nx // 2],
                    np.asarray(out["WSUM"])[0], rtol=1e-12)


def test_hessian_dds_ragged_channels(tmp_path):
    """Ragged channel chunks (5 channels imaged 2+2+1) pad into the
    stacked one-program Hessian with zero weight/mask and agree with
    the per-dataset loop (regression: stack_dds used to assert equal
    nchan)."""
    import jax.numpy as jnp

    from pfb_tpu.ops.gridder import hessian_dds, make_hessian_dds
    from pfb_tpu.utils.ms import simulate_ms
    from pfb_tpu.workers.grid import _grid
    from pfb_tpu.workers.init import _init

    ms_path = str(tmp_path / "r.npz")
    simulate_ms(ms_path, nant=7, ntime=4, nchan=5, nsource=2,
                fov_deg=0.3, seed=13)
    xds = _init(ms=ms_path, write=False, channels_per_image=2)
    assert sorted(ds["FREQ"].size for ds in xds) == [1, 2, 2]
    dds = _grid(xdsi=xds, write=False, field_of_view=0.3,
                robustness=None, psf=False, residual=False)
    nband = len(dds)
    nx = dds[0]["DIRTY"].shape[0]
    wsum = float(np.sum([d["WSUM"][0] for d in dds]))
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(nband, nx, nx)))
    hess = make_hessian_dds(dds, nband, wsum, nx, nx, use_beam=False)
    got = np.asarray(hess(x))
    ref = np.asarray(hessian_dds(x, dds, wsum, use_beam=False))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_counts_windowed_scatter_matches_elementwise(obs):
    """The windowed-scatter ES counts (one (k,k) update per vis) must
    reproduce the per-tap scatter exactly, INCLUDING points whose
    stencil pokes over the grid edge (the padded margins implement
    per-tap drop semantics)."""
    nx = 32  # small grid so edge stencils occur
    cell = 1.0 / (2 * np.abs(obs.uvw[:, :2]).max() * obs.freq.max()
                  / LIGHTSPEED)
    mask = np.ones((obs.uvw.shape[0], obs.freq.size), np.uint8)
    k = 6
    got = np.asarray(compute_counts(
        jnp.asarray(obs.uvw), jnp.asarray(obs.freq),
        jnp.asarray(mask), nx, nx, cell, cell, k=k))

    # independent per-tap numpy reference with drop semantics
    u_cell = 1.0 / (nx * cell)
    umax = abs(-1.0 / cell / 2.0 - u_cell / 2.0)
    normfreq = obs.freq / LIGHTSPEED
    ug = (obs.uvw[:, 0:1] * normfreq[None, :] + umax) / u_cell
    vg = (obs.uvw[:, 1:2] * normfreq[None, :] + umax) / u_cell
    ko2 = k // 2
    ref = np.zeros((nx, nx))

    def es(x):
        arg = np.maximum((1.0 - x) * (1.0 + x), 0.0)
        return np.where(np.abs(x) <= 1.0,
                        np.exp(2.3 * k * (np.sqrt(arg) - 1.0)), 0.0)

    for r in range(ug.shape[0]):
        for c in range(ug.shape[1]):
            ui = int(np.round(ug[r, c]))
            vi = int(np.round(vg[r, c]))
            for i in range(-ko2, ko2):
                xi = ui + i
                if not (0 <= xi < nx):
                    continue
                xv = es((xi - ug[r, c] + 0.5) / ko2)
                for j in range(-ko2, ko2):
                    yi = vi + j
                    if not (0 <= yi < nx):
                        continue
                    ref[xi, yi] += xv * es((yi - vg[r, c] + 0.5) / ko2)
    # some stencil must actually hit the edge for this test to count
    assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * max(ref.max(), 1))


def test_counts_host_matches_device(obs):
    """The host bincount counts (production weighting path) must match
    the jitted device scatter exactly."""
    from pfb_tpu.ops.weighting import compute_counts_host
    nx = 48
    cell = 1.0 / (2 * np.abs(obs.uvw[:, :2]).max() * obs.freq.max()
                  / LIGHTSPEED)
    mask = np.ones((obs.uvw.shape[0], obs.freq.size), np.uint8)
    for k in (6, 0):
        dev = np.asarray(compute_counts(
            jnp.asarray(obs.uvw), jnp.asarray(obs.freq),
            jnp.asarray(mask), nx, nx, cell, cell, k=k))
        host = compute_counts_host(obs.uvw, obs.freq, mask, nx, nx,
                                   cell, cell, k=k, row_chunk=37)
        assert_allclose(host, dev, rtol=1e-6,
                        atol=1e-9 * max(dev.max(), 1))


def _unpack(obs, seed=9):
    """Host float64 geometry, weighted random visibilities and a
    64^2 image size for the Gridder tests."""
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(seed)
    shape = (obs.uvw.shape[0], obs.freq.size)
    vis = jnp.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    wgt = jnp.asarray(rng.random(shape))
    mask = jnp.asarray((rng.random(shape) > 0.1).astype(np.float64))
    return obs.uvw, obs.freq, vis, wgt, mask, nx, cell


@pytest.mark.parametrize("do_w", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_gridder_wgrid_matches_dft(obs, do_w, shift):
    """The planned Gridder: 'wgrid' agrees with the exact 'dft' both
    ways, with and without w-stacking and a shifted centre."""
    from pfb_tpu.ops.gridder import Gridder
    uvw, freq, vis, wgt, mask, nx, cell = _unpack(obs)
    x0, y0 = (2 * cell, -3 * cell) if shift else (0.0, 0.0)
    kw = dict(nx=nx, ny=nx, cell=cell, epsilon=1e-9, do_wgridding=do_w,
              x0=x0, y0=y0)
    gw = Gridder("wgrid", uvw, freq, **kw)
    gd = Gridder("dft", jnp.asarray(uvw), jnp.asarray(freq), **kw)
    a = np.asarray(gw.vis2dirty(vis, wgt=wgt, mask=mask))
    b = np.asarray(gd.vis2dirty(vis, wgt=wgt, mask=mask))
    assert np.abs(a - b).max() < 1e-7 * np.abs(b).max()
    img = jnp.asarray(np.random.default_rng(5).normal(size=(nx, nx)))
    va = np.asarray(gw.dirty2vis(img))
    vb = np.asarray(gd.dirty2vis(img))
    assert np.abs(va - vb).max() < 1e-7 * np.abs(vb).max()


def test_gridder_plan_reuse_is_exact(obs):
    """Reusing one plan gives bit-identical results to planning per
    call, both directions."""
    from pfb_tpu.ops.gridder import Gridder
    from pfb_tpu.ops.wgridder import dirty2vis_wgrid, vis2dirty_wgrid
    uvw, freq, vis, wgt, mask, nx, cell = _unpack(obs)
    g = Gridder("wgrid", uvw, freq, nx=nx, ny=nx, cell=cell)
    a = np.asarray(g.vis2dirty(vis))
    b = np.asarray(vis2dirty_wgrid(uvw, freq, vis, nx=nx, ny=nx,
                                   cellx=cell, celly=cell))
    assert np.array_equal(a, b)
    img = jnp.asarray(np.random.default_rng(6).normal(size=(nx, nx)))
    assert np.array_equal(np.asarray(g.dirty2vis(img)),
                          np.asarray(dirty2vis_wgrid(uvw, freq, img, cell,
                                                     cell)))


@pytest.mark.parametrize("backend,known", [("dft", True), ("wgrid", True),
                                           ("mm", False), ("pg", False)])
def test_get_backend_names(obs, backend, known):
    from pfb_tpu.ops.gridder import get_backend
    if not known:
        with pytest.raises(ValueError):
            get_backend(backend)
        return
    uvw, freq, vis, wgt, mask, nx, cell = _unpack(obs)
    d2v, v2d = get_backend(backend, epsilon=1e-7, do_wgridding=True)
    d = v2d(jnp.asarray(uvw), jnp.asarray(freq), vis, nx=nx, ny=nx,
            cellx=cell, celly=cell)
    assert d.shape == (nx, nx)


def test_gridder_commits_plan_to_device(obs):
    """device= puts the plan on one device; the products land there."""
    import jax
    from pfb_tpu.ops.gridder import Gridder
    uvw, freq, vis, wgt, mask, nx, cell = _unpack(obs)
    dev = jax.devices()[3]
    g = Gridder("wgrid", uvw, freq, nx=nx, ny=nx, cell=cell, device=dev)
    img = g.vis2dirty(jax.device_put(vis, dev))
    assert img.devices() == {dev}
    assert g.dirty2vis(img).devices() == {dev}
