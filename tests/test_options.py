"""New schema-parity options: target parsing, radec rephasing,
double-accum gridding, local-mean count filtering, schema mixins."""

import numpy as np
import pytest


def test_parse_target_formats():
    from pfb_tpu.utils.astrometry import parse_target
    ra, dec = parse_target("12:00:00,-30:00:00")
    assert np.isclose(ra, np.pi)
    assert np.isclose(dec, -np.pi / 6)
    ra, dec = parse_target("0.5,-0.3")
    assert (ra, dec) == (0.5, -0.3)
    ra, dec = parse_target("Sun", obs_time=5e9)
    assert 0 <= ra < 2 * np.pi and abs(dec) < 0.42  # |dec| <= 23.5 deg
    ra, dec = parse_target("Jupiter", obs_time=5e9)
    assert 0 <= ra < 2 * np.pi and abs(dec) < 0.45
    with pytest.raises(ValueError):
        parse_target("Vulcan", obs_time=5e9)


def test_rephase_to_matches_independent_uvw():
    """Rephasing (vis, uvw) from centre A to centre B must agree with
    visibilities synthesised directly in frame B: uvw' == uvw computed
    with synthesize_uvw at B, and vis' == the DFT-oracle model vis of
    the same sky evaluated with frame-B uvw and lm."""
    import jax.numpy as jnp

    from pfb_tpu.ops.dft import dirty2vis_dft
    from pfb_tpu.utils.astrometry import (radec_to_lm, rephase_to,
                                          synthesize_uvw)

    rng = np.random.default_rng(0)
    nant = 5
    enu = rng.normal(scale=300.0, size=(nant, 3))
    enu[:, 2] *= 0.05
    a1, a2 = np.triu_indices(nant, 1)
    times = np.repeat(np.arange(3) * 600.0, a1.size)
    ant1 = np.tile(a1, 3)
    ant2 = np.tile(a2, 3)
    lat = -0.5
    A = (1.0, -0.6)
    B = (1.0 + 2e-3, -0.6 + 1.5e-3)
    uvw_A = synthesize_uvw(enu, times, ant1, ant2, A, lat)
    uvw_B = synthesize_uvw(enu, times, ant1, ant2, B, lat)

    freq = np.linspace(1.0e9, 1.2e9, 3)
    # a 1 Jy source offset from A; pixel grid centred on each frame
    nx, cell = 64, 4e-4 / 64
    src = (1.0 + 0.8e-3, -0.6 - 0.5e-3)

    def model_vis(uvw, centre):
        # unit source at the grid centre, grid recentred on the source
        # via (x0, y0) = its direction cosines w.r.t. this frame
        l, m = radec_to_lm(src, centre)
        img = np.zeros((nx, nx))
        img[nx // 2, nx // 2] = 1.0
        return dirty2vis_dft(uvw, freq, jnp.asarray(img), nx=nx, ny=nx,
                             cellx=cell, celly=cell, x0=l, y0=m)

    vis_A = np.asarray(model_vis(uvw_A, A))
    vis_B = np.asarray(model_vis(uvw_B, B))

    vis_r, uvw_r = rephase_to(vis_A, uvw_A, A, B, freq)
    assert np.abs(uvw_r - uvw_B).max() < 1e-6 * np.abs(uvw_B).max()
    assert np.abs(vis_r - vis_B).max() < 1e-6


def test_double_accum_closer_to_f64():
    """f32 gridding with double_accum=True must be at least as close
    to the f64 answer as plain f32 accumulation."""
    import jax.numpy as jnp

    from pfb_tpu.ops.wgridder import vis2dirty_wgrid

    rng = np.random.default_rng(3)
    nrow, nchan, nx = 3000, 2, 64
    uvw = rng.normal(scale=400.0, size=(nrow, 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    cell = 1.0 / (2 * umax * 2.0)
    vis = (rng.normal(size=(nrow, nchan))
           + 1j * rng.normal(size=(nrow, nchan)))

    kw = dict(nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=1e-5,
              do_wgridding=True)
    ref = np.asarray(vis2dirty_wgrid(uvw, freq, vis, **kw))  # f64
    v32 = jnp.asarray(vis.astype(np.complex64))
    d32 = np.asarray(vis2dirty_wgrid(uvw, freq, v32, **kw))
    d64 = np.asarray(vis2dirty_wgrid(uvw, freq, v32, double_accum=True,
                                     **kw))
    scale = np.abs(ref).max()
    e32 = np.abs(d32 - ref).max() / scale
    e64 = np.abs(d64 - ref).max() / scale
    assert e64 <= e32 * 1.01
    assert e64 < 1e-5


def test_filter_extreme_counts_nbox():
    from pfb_tpu.ops.weighting import filter_extreme_counts

    counts = np.zeros((32, 32))
    counts[8:16, 8:16] = 100.0
    counts[12, 12] = 1.0      # extreme low inside a dense region
    counts[30, 30] = 5.0      # isolated occupied cell
    out = filter_extreme_counts(counts, level=10.0, nbox=4)
    assert out[12, 12] > 50.0          # raised to the local mean
    assert out[30, 30] == 0.0          # too isolated -> zeroed
    assert out[9, 9] == 100.0          # healthy cells untouched
    # global-median mode (reference live behaviour) unchanged
    out2 = filter_extreme_counts(counts, level=10.0)
    assert out2[12, 12] == 10.0        # median(100...)/10


def test_schema_mixins_resolved():
    from pfb_tpu.parser.schemas import defaults_for, schema

    inputs = schema["klean"]["inputs"]
    assert "_include" not in inputs
    assert "cg-tol" in inputs and "epsilon" in inputs
    assert "log-directory" in inputs
    # worker override beats the mixin default
    assert schema["fwdbwd"]["inputs"]["cg-tol"]["default"] == 1e-4
    d = defaults_for("spotless")
    assert d["pd_report_freq"] == 50 and d["do_wgridding"] is True


def test_solver_verbosity_smoke():
    """verbosity>=2 paths trace and run (jax.debug.print in the
    while_loop body)."""
    import jax.numpy as jnp

    from pfb_tpu.opt.pcg import pcg, pcg_bands

    A = lambda x: 2.0 * x
    b = jnp.ones((8, 8))
    x = pcg(A, b, tol=1e-9, maxit=20, minit=2, verbosity=2,
            report_freq=5)
    assert np.allclose(np.asarray(x), 0.5, atol=1e-6)
    bb = jnp.ones((2, 8, 8))
    x = pcg_bands(A, bb, tol=1e-9, maxit=20, minit=2, verbosity=2,
                  report_freq=5)
    assert np.allclose(np.asarray(x), 0.5, atol=1e-6)
