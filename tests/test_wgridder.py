"""ES-kernel w-stacking gridder vs the exact DFT oracle.

The reference trusts ducc0's wgridder at epsilon=1e-7
(pfb/parser/gridding.yml); here the from-scratch implementation is
validated against the exact-DFT measurement operator at the same
accuracy regime."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.ops.dft import dirty2vis_dft, vis2dirty_dft
from pfb_tpu.ops.wgridder import dirty2vis_wgrid, vis2dirty_wgrid
from pfb_tpu.utils.simulation import image_size_for, simulate_obs

pmp = pytest.mark.parametrize


@pytest.fixture(scope="module")
def obs():
    return simulate_obs(nant=7, ntime=6, nchan=2, seed=3)


def _vis(obs, rng):
    nrow, nchan = obs.uvw.shape[0], obs.freq.size
    return jnp.asarray(rng.normal(size=(nrow, nchan)) +
                       1j * rng.normal(size=(nrow, nchan)))


@pmp("do_w", [False, True])
def test_vis2dirty_matches_dft(obs, do_w):
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(0)
    vis = _vis(obs, rng)
    wgt = jnp.asarray(rng.random(vis.shape))
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)

    ref = np.asarray(vis2dirty_dft(uvw, freq, vis, wgt=wgt, nx=nx,
                                   ny=nx, cellx=cell, celly=cell,
                                   do_wterm=do_w))
    got = np.asarray(vis2dirty_wgrid(uvw, freq, vis, wgt=wgt, nx=nx,
                                     ny=nx, cellx=cell, celly=cell,
                                     epsilon=1e-7, do_wgridding=do_w))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-6


@pmp("do_w", [False, True])
def test_dirty2vis_matches_dft(obs, do_w):
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.normal(size=(nx, nx)))
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)

    ref = np.asarray(dirty2vis_dft(uvw, freq, img, cell, cell,
                                   do_wterm=do_w))
    got = np.asarray(dirty2vis_wgrid(uvw, freq, img, cell, cell,
                                     epsilon=1e-7, do_wgridding=do_w))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-6


def test_adjointness_wgrid(obs):
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(nx, nx)))
    y = _vis(obs, rng)
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)

    Rx = np.asarray(dirty2vis_wgrid(uvw, freq, x, cell, cell,
                                    epsilon=1e-9))
    RHy = np.asarray(vis2dirty_wgrid(uvw, freq, y, nx=nx, ny=nx,
                                     cellx=cell, celly=cell,
                                     epsilon=1e-9))
    lhs = np.sum(Rx.real * np.asarray(y.real) +
                 Rx.imag * np.asarray(y.imag))
    rhs = np.sum(np.asarray(x) * RHy)
    assert_allclose(lhs, rhs, rtol=1e-6)


@pmp("do_w", [False, True])
def test_shifted_centre_matches_dft(obs, do_w):
    """x0/y0 phase-centre shifts (used for multi-field/target imaging,
    reference grid.py:354-377)."""
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(5)
    x0, y0 = 3 * cell, -2 * cell
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)
    vis = _vis(obs, rng)
    ref = np.asarray(vis2dirty_dft(uvw, freq, vis, nx=nx, ny=nx,
                                   cellx=cell, celly=cell, x0=x0,
                                   y0=y0, do_wterm=do_w))
    got = np.asarray(vis2dirty_wgrid(uvw, freq, vis, nx=nx, ny=nx,
                                     cellx=cell, celly=cell, x0=x0,
                                     y0=y0, epsilon=1e-7,
                                     do_wgridding=do_w))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6
    img = jnp.asarray(rng.normal(size=(nx, nx)))
    refv = np.asarray(dirty2vis_dft(uvw, freq, img, cell, cell, x0=x0,
                                    y0=y0, do_wterm=do_w))
    gotv = np.asarray(dirty2vis_wgrid(uvw, freq, img, cell, cell,
                                      x0=x0, y0=y0, epsilon=1e-7,
                                      do_wgridding=do_w))
    assert np.abs(gotv - refv).max() / np.abs(refv).max() < 1e-6


@pmp("eps,tol", [(1e-5, 1e-4), (1e-7, 1e-6), (1e-9, 1e-8)])
def test_accuracy_scales_with_epsilon(obs, eps, tol):
    nx, cell = image_size_for(obs, fov_deg=0.15)
    nx = min(nx, 48)
    rng = np.random.default_rng(4)
    vis = _vis(obs, rng)
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)
    ref = np.asarray(vis2dirty_dft(uvw, freq, vis, nx=nx, ny=nx,
                                   cellx=cell, celly=cell))
    got = np.asarray(vis2dirty_wgrid(uvw, freq, vis, nx=nx, ny=nx,
                                     cellx=cell, celly=cell,
                                     epsilon=eps))
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, f"eps={eps}: err={err:.2e}"


def test_f32_phase_recurrence_matches_f64(obs):
    """The f32 chip path replaces per-w-plane cos/sin with a phasor
    rotation recurrence (round-4); its drift must stay below the f32
    gridder accuracy floor: compare the f32 adjoint against the f64
    exact-phase path at eps=1e-5."""
    nx, cell = image_size_for(obs, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(4)
    vis = _vis(obs, rng)
    uvw = jnp.asarray(obs.uvw)
    freq = jnp.asarray(obs.freq)

    ref = np.asarray(vis2dirty_wgrid(uvw, freq, vis, nx=nx, ny=nx,
                                     cellx=cell, celly=cell,
                                     epsilon=1e-5, do_wgridding=True))
    got = np.asarray(vis2dirty_wgrid(
        jnp.asarray(obs.uvw, jnp.float32),
        jnp.asarray(obs.freq, jnp.float32),
        jnp.asarray(np.asarray(vis), jnp.complex64), nx=nx, ny=nx,
        cellx=cell, celly=cell, epsilon=1e-5, do_wgridding=True))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-5

    # forward twin (image_to_grid recurrence)
    img = np.asarray(ref, np.float64)
    vref = np.asarray(dirty2vis_wgrid(uvw, freq, jnp.asarray(img),
                                      cell, cell, epsilon=1e-5,
                                      do_wgridding=True))
    vgot = np.asarray(dirty2vis_wgrid(
        jnp.asarray(obs.uvw, jnp.float32),
        jnp.asarray(obs.freq, jnp.float32),
        jnp.asarray(img, jnp.float32), cell, cell, epsilon=1e-5,
        do_wgridding=True))
    vscale = np.abs(vref).max()
    assert np.abs(vgot - vref).max() / vscale < 1e-5


@pmp("shift", [False, True])
@pmp("plane_block", [1, 2, 3])
def test_wplane_blocks_match_unblocked(obs, shift, plane_block,
                                       monkeypatch):
    """Gridding the w planes in blocks (visibilities sorted by base
    plane, one contiguous window per block, several chunks each) is
    the same operator as the all-planes stack, both directions."""
    import pfb_tpu.ops.wgridder as wg
    nx, cell = image_size_for(obs, fov_deg=0.4)
    nx = min(nx, 64)
    x0, y0 = (3 * cell, -2 * cell) if shift else (0.0, 0.0)
    kw = dict(nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=1e-7,
              x0=x0, y0=y0)
    full = wg.wgrid_plan(obs.uvw, obs.freq, **kw)
    Nx, Ny = full["Nx"], full["Ny"]
    monkeypatch.setattr(wg, "GRID_BLOCK_BYTES",
                        plane_block * 2 * Nx * Ny * 8)
    monkeypatch.setattr(wg, "VIS_CHUNK", 128)
    blk = wg.wgrid_plan(obs.uvw, obs.freq, **kw)
    assert full["nw"] > 3 and len(full["blocks"]) == 1
    assert len(blk["blocks"]) == -(-full["nw"] // plane_block)
    rng = np.random.default_rng(6)
    vis = _vis(obs, rng)
    a = np.asarray(vis2dirty_wgrid(None, None, vis, nx=nx, ny=nx,
                                   cellx=cell, celly=cell, plan=full))
    b = np.asarray(vis2dirty_wgrid(None, None, vis, nx=nx, ny=nx,
                                   cellx=cell, celly=cell, plan=blk))
    assert_allclose(b, a, rtol=1e-11, atol=1e-11 * np.abs(a).max())
    img = jnp.asarray(rng.normal(size=(nx, nx)))
    va = np.asarray(dirty2vis_wgrid(None, None, img, cell, cell,
                                    plan=full))
    vb = np.asarray(dirty2vis_wgrid(None, None, img, cell, cell,
                                    plan=blk))
    assert_allclose(vb, va, rtol=1e-11, atol=1e-11 * np.abs(va).max())
