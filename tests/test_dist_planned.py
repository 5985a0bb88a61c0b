"""Band-sharded exact vis-space Hessian through the planned XLA
gridder (parallel.dist.make_hessian_dds_dist with 'wgrid'):
each band's plan lives on the device that owns the band and the
matvec needs no communication; it must agree with the single-device
operator, and spotless_dist with spotless."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.ops.gridder import make_hessian_dds
from pfb_tpu.parallel.dist import band_devices, make_hessian_dds_dist
from pfb_tpu.parallel.mesh import band_sharding, make_mesh


@pytest.fixture(scope="module")
def dds4(tmp_path_factory):
    """4 bands x 2 time chunks of a small simulated observation."""
    from pfb_tpu.utils.ms import simulate_ms
    from pfb_tpu.workers.grid import _grid
    from pfb_tpu.workers.init import _init

    tmp = tmp_path_factory.mktemp("dist_planned")
    ms = str(tmp / "t.npz")
    simulate_ms(ms, nant=6, ntime=4, nchan=4, nsource=2, fov_deg=0.2,
                seed=21, gains=False)
    xds = _init(ms=ms, output_filename=str(tmp / "o"),
                channels_per_image=1, integrations_per_image=2,
                write=False)
    return _grid(xdsi=xds, output_filename=None, field_of_view=0.2,
                 robustness=0.0, psf=True, residual=False, write=False,
                 backend="dft")


def _cube(dds, seed=0):
    nx, ny = dds[0]["DIRTY"].shape
    rng = np.random.default_rng(seed)
    return rng.normal(size=(4, nx, ny))


@pytest.mark.parametrize("sigmainv", [0.0, 1e-2])
def test_hessian_dds_dist_planned_matches_local(dds4, sigmainv):
    nx, ny = dds4[0]["DIRTY"].shape
    wsum = sum(float(d["WSUM"][0]) for d in dds4)
    mesh = make_mesh(nband=4, nspace=1, devices=jax.devices()[:4])
    x = _cube(dds4)
    kw = dict(use_beam=False, backend="wgrid", epsilon=1e-7,
              sigmainv=sigmainv)
    ref = np.asarray(make_hessian_dds(dds4, 4, wsum, nx, ny, **kw)(
        jnp.asarray(x)))
    hd = make_hessian_dds_dist(mesh, dds4, 4, wsum, nx, ny, **kw)
    xd = jax.device_put(jnp.asarray(x), band_sharding(mesh))
    out = hd(xd)
    assert out.sharding.is_equivalent_to(band_sharding(mesh), 3)
    assert_allclose(np.asarray(out), ref, rtol=1e-12,
                    atol=1e-12 * np.abs(ref).max())


def test_hessian_dds_dist_planned_space_replicas(dds4):
    """On a (band, space) mesh every space replica of a band block
    receives the same exact residual."""
    nx, ny = dds4[0]["DIRTY"].shape
    wsum = sum(float(d["WSUM"][0]) for d in dds4)
    mesh = make_mesh(nband=2, nspace=4)
    x = _cube(dds4, seed=1)
    ref = np.asarray(make_hessian_dds(dds4, 4, wsum, nx, ny,
                                      use_beam=False, backend="wgrid")(
        jnp.asarray(x)))
    hd = make_hessian_dds_dist(mesh, dds4, 4, wsum, nx, ny,
                               use_beam=False, backend="wgrid")
    out = hd(jax.device_put(jnp.asarray(x), band_sharding(mesh)))
    for sh in out.addressable_shards:
        b = sh.index[0]
        assert_allclose(np.asarray(sh.data), ref[b], rtol=1e-12,
                        atol=1e-12 * np.abs(ref).max())


def test_band_devices_follow_the_cube_sharding():
    mesh = make_mesh(nband=4, nspace=2)
    devs = band_devices(mesh, 8)
    x = jax.device_put(jnp.zeros((8, 4, 4)), band_sharding(mesh))
    for sh in x.addressable_shards:
        for b in range(8)[sh.index[0]]:
            assert devs[b].id <= sh.device.id
    assert len({d.id for d in devs}) == 4


def test_spotless_dist_planned_backend_matches_local(dds4):
    """spotless_dist with the planned 'wgrid' exact residual on a
    4-device band mesh reproduces single-device spotless."""
    from pfb_tpu.workers.spotless import _spotless, _spotless_dist

    kw = dict(niter=2, rmsfactor=0.5, gamma=1.0, bases="self,db1",
              nlevels=2, l1reweight_from=2, pd_tol=1e-6, pd_maxit=80,
              hessnorm=2.0, backend="wgrid", verbose=0, write=False)
    m_loc, r_loc = _spotless(ddsi=[dict(d) for d in dds4], **kw)
    mesh = make_mesh(nband=4, nspace=1, devices=jax.devices()[:4])
    m_d, r_d = _spotless_dist(mesh=mesh,
                              ddsi=[dict(d) for d in dds4], **kw)
    assert np.abs(m_loc).max() > 0
    assert_allclose(m_d, m_loc, rtol=1e-8,
                    atol=1e-8 * np.abs(m_loc).max())
    assert_allclose(r_d, r_loc, rtol=1e-8,
                    atol=1e-8 * np.abs(r_loc).max())
