"""End-to-end flux recovery through the FAST gridder backends.

The unit suites validate 'wgrid' against the exact-DFT
oracle per call; this runs the whole init -> grid -> klean pipeline
through them (reference tests/test_klean.py semantics) so a w-term or
grid-correction bug that cancels at unit scale cannot ship.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.grid import _grid
from pfb_tpu.workers.init import _init
from pfb_tpu.workers.klean import _klean

pytestmark = pytest.mark.slow

pmp = pytest.mark.parametrize


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e_backends")
    ms_path = str(tmp / "test.npz")
    model, Ix, Iy, nx, cell_rad, _ = simulate_ms(
        ms_path, nant=9, ntime=6, nchan=2, nsource=3, fov_deg=0.25,
        seed=99, gains=False)
    outname = str(tmp / "out")
    xds = _init(ms=ms_path, output_filename=outname,
                channels_per_image=1)
    return dict(model=model, Ix=Ix, Iy=Iy, nx=nx, cell_rad=cell_rad,
                outname=outname, xds=xds, ms_path=ms_path)


def _ncorr(nx, cell_rad, Ix, Iy):
    l = (np.arange(nx) - nx // 2) * cell_rad
    ll, mm = np.meshgrid(l, l, indexing="ij")
    eps = ll**2 + mm**2
    n = 1 - eps / (np.sqrt(1 - eps) + 1)
    return n[Ix, Iy]


@pytest.fixture(scope="module")
def klean_dft(sim, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kdft")
    dds = _grid(xdsi=sim["xds"], output_filename=str(tmp / "o"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=True, residual=False, backend="dft")
    rec, resid = _klean(ddsi=[dict(ds) for ds in dds],
                        output_filename=str(tmp / "klean"),
                        niter=3, threshold=1e-5, gamma=0.1,
                        peak_factor=0.75, sub_peak_factor=0.75,
                        mop_flux=False, dirosion=0, verbose=0,
                        backend="dft")
    return rec, resid


@pmp("backend", ["wgrid"])
def test_klean_through_backend(sim, klean_dft, tmp_path, backend):
    """klean major cycles through the fast backend track the exact-DFT
    run: the minors are identical given the same inputs, so any drift
    isolates the gridder's dirty/PSF/exact-residual chain (reference
    R/R.H consistency, tests/test_spotless.py:322-325)."""
    p = sim
    dds = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "o"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=True, residual=False, backend=backend)
    rec, resid = _klean(ddsi=[dict(ds) for ds in dds],
                        output_filename=str(tmp_path / "klean"),
                        niter=3, threshold=1e-5, gamma=0.1,
                        peak_factor=0.75, sub_peak_factor=0.75,
                        mop_flux=False, dirosion=0, verbose=0,
                        backend=backend)
    rec_ref, resid_ref = klean_dft
    peak = np.abs(rec_ref).max()
    assert np.abs(rec - rec_ref).max() < 1e-4 * peak
    rpeak = np.abs(resid_ref).max()
    assert np.abs(resid - resid_ref).max() < 1e-3 * rpeak


def test_degrid_regrid_residual_consistency(sim, klean_dft, tmp_path):
    """The reference R/R.H round trip
    (tests/test_spotless.py:322-325) through backend "wgrid": fit the
    CLEAN model to components, (a) re-grid with --transfer-model-from
    and (b) degrid the model into MODEL_DATA, re-init with
    DATA-MODEL_DATA column arithmetic and re-grid — both residual
    paths must reproduce the deconvolver's final residual."""
    from pfb_tpu.utils.ms import read_ms
    from pfb_tpu.workers.degrid import _degrid
    from pfb_tpu.workers.model2comps import _model2comps

    p = sim
    rec, resid = klean_dft
    nband = rec.shape[0]
    dds = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "o"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=True, residual=False, backend="wgrid")
    wsum = np.sum([ds["WSUM"][0] for ds in dds])
    for ds in dds:
        ds["MODEL"] = rec[ds["bandid"]]
    mds = _model2comps(ddsi=dds, output_filename=str(tmp_path / "m"),
                       nbasisf=nband, fit_mode="Legendre")

    # (a) --transfer-model-from: residual computed at grid time
    dds_t = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "t"),
                  suffix="main", field_of_view=0.25, robustness=0.0,
                  psf=False, residual=True, backend="wgrid",
                  transfer_model_from=mds)
    res_t = np.zeros_like(resid)
    for ds in dds_t:
        res_t[ds["bandid"]] += ds["RESIDUAL"] / wsum
    scale = np.abs(resid).max()
    assert np.abs(res_t - resid).max() < 1e-4 * scale

    # (b) degrid -> DATA-MODEL_DATA -> re-grid: dirty == residual
    _degrid(ms=p["ms_path"], mds=mds, backend="wgrid",
            channels_per_image=1)
    xds2 = _init(ms=p["ms_path"], write=False,
                 data_column="DATA-MODEL_DATA", channels_per_image=1)
    dds_r = _grid(xdsi=xds2, output_filename=str(tmp_path / "r"),
                  suffix="main", field_of_view=0.25, robustness=0.0,
                  psf=False, residual=False, backend="wgrid")
    res_r = np.zeros_like(resid)
    for ds in dds_r:
        res_r[ds["bandid"]] += ds["DIRTY"] / wsum
    assert np.abs(res_r - resid).max() < 1e-4 * scale


@pmp("backend", ["wgrid"])
def test_dirty_parity_between_backends(sim, tmp_path, backend):
    """grid through the fast backend == grid through the DFT oracle
    at the gridder's epsilon (catches normalisation/x0/y0 drift at
    pipeline scale)."""
    p = sim
    ref = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "r"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=False, residual=False, backend="dft")
    got = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "g"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=False, residual=False, backend=backend)
    for dr, dg in zip(ref, got):
        scale = np.abs(dr["DIRTY"]).max()
        assert np.abs(dg["DIRTY"] - dr["DIRTY"]).max() < 1e-6 * scale


def test_l2reweight_downweights_corrupted_rows(sim, klean_dft,
                                               tmp_path):
    """Student-t l2 reweighting end-to-end (reference
    gridder.py:608-616 via grid --l2reweight-dof): rows with corrupted
    visibilities get strongly downweighted relative to clean rows once
    a model is transferred in."""
    from pfb_tpu.utils.ms import read_ms, write_ms
    from pfb_tpu.workers.model2comps import _model2comps

    p = sim
    rec, _ = klean_dft
    dds = _grid(xdsi=p["xds"], output_filename=str(tmp_path / "o"),
                suffix="main", field_of_view=0.25, robustness=0.0,
                psf=True, residual=False)
    for ds in dds:
        ds["MODEL"] = rec[ds["bandid"]]
    mds = _model2comps(ddsi=dds, output_filename=str(tmp_path / "m"),
                       nbasisf=rec.shape[0], fit_mode="Legendre")

    # corrupt a block of rows in a copy of the MS
    ms = read_ms(p["ms_path"])
    ms.pop("MODEL_DATA", None)
    nrow = ms["DATA"].shape[0]
    bad = np.arange(nrow // 8)
    ms["DATA"][bad] += 5.0 * np.abs(ms["DATA"]).max()
    ms_bad = str(tmp_path / "bad.npz")
    write_ms(ms_bad, **ms)
    xds = _init(ms=ms_bad, write=False, channels_per_image=1)

    dds_rw = _grid(xdsi=xds, output_filename=str(tmp_path / "rw"),
                   suffix="main", field_of_view=0.25, robustness=0.0,
                   psf=False, residual=True, weight=True,
                   l2reweight_dof=2.0, transfer_model_from=mds)
    # with dof=2 and 1/8 of rows corrupted, r^2/ovar ~ 8 on the bad
    # rows -> weight ratio ~ (2+1)/(2+8) ~ 0.3 of the clean rows
    for ds in dds_rw:
        w = ds["WEIGHT"]
        assert np.median(w[bad]) < 0.4 * np.median(w[nrow // 8:nrow])
