"""Multi-device (8 virtual CPU devices) tests of the band-sharded
solvers — must agree with the single-program versions to float64
precision. This is the distributed coverage the reference never had
(SURVEY.md section 4: "Multi-node/distributed testing: none")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.ops.fft import make_psfhat
from pfb_tpu.ops.psf import make_psf_convolve
from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu.opt.power_method import power_method
from pfb_tpu.opt.primal_dual import primal_dual
from pfb_tpu.parallel.dist import (hessian_psf_dist, pcg_dist,
                                   power_method_dist, primal_dual_dist)
from pfb_tpu.parallel.mesh import band_sharding, make_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 cpu devices"
    return make_mesh(nband=8, nspace=1)


def _psf_setup(nband=8, nx=32, ny=32):
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nxp // 2, nyp // 2] += 0.5
    psfhat = np.asarray(make_psfhat(psf))
    return psf, psfhat, nyp


def test_hessian_dist_matches_local(mesh8):
    nband, nx, ny = 8, 32, 32
    psf, psfhat, lastsize = _psf_setup(nband, nx, ny)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(nband, nx, ny))

    sh = band_sharding(mesh8)
    xd = jax.device_put(jnp.asarray(x), sh)
    phd = jax.device_put(jnp.asarray(psfhat), sh)
    hess_d = hessian_psf_dist(mesh8, lastsize)
    out_d = np.asarray(hess_d(xd, phd))

    hess = make_psf_convolve(jnp.asarray(psfhat), lastsize)
    out = np.asarray(hess(jnp.asarray(x)))
    assert_allclose(out_d, out, rtol=1e-12, atol=1e-12)


def test_power_method_dist_matches_local(mesh8):
    nband, nx, ny = 8, 32, 32
    psf, psfhat, lastsize = _psf_setup(nband, nx, ny)
    rng = np.random.default_rng(1)
    b0 = rng.normal(size=(nband, nx, ny))

    sh = band_sharding(mesh8)
    pm_d = power_method_dist(mesh8, lastsize, tol=1e-10, maxit=500)
    beta_d, _ = pm_d(jax.device_put(jnp.asarray(b0), sh),
                     jax.device_put(jnp.asarray(psfhat), sh))

    hess = make_psf_convolve(jnp.asarray(psfhat), lastsize)
    beta, _ = power_method(hess, (nband, nx, ny), b0=jnp.asarray(b0),
                           tol=1e-10, maxit=500, dtype=jnp.float64)
    assert_allclose(float(beta_d), float(beta), rtol=1e-8)


def test_pcg_dist_matches_local(mesh8):
    nband, nx, ny = 8, 32, 32
    psf, psfhat, lastsize = _psf_setup(nband, nx, ny)
    rng = np.random.default_rng(2)
    model = np.zeros((nband, nx, ny))
    model[:, 10, 12] = 1.0
    model[:, 20, 8] = 2.0

    sigmainv = 1e-3
    hess = make_psf_convolve(jnp.asarray(psfhat), lastsize,
                             sigmainv=sigmainv)
    b = hess(jnp.asarray(model))

    from pfb_tpu.opt.pcg import pcg_psf
    x_local = np.asarray(pcg_psf(jnp.asarray(psfhat), b,
                                 jnp.zeros_like(b), sigmainv=sigmainv,
                                 tol=1e-10, maxit=200, minit=10))

    sh = band_sharding(mesh8)
    solver = pcg_dist(mesh8, lastsize, sigmainv=sigmainv, tol=1e-10,
                      maxit=200, minit=10)
    x_dist = np.asarray(solver(jax.device_put(b, sh),
                               jax.device_put(jnp.zeros_like(b), sh),
                               jax.device_put(jnp.asarray(psfhat), sh)))
    assert_allclose(x_dist, x_local, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("positivity", [1, 2])
def test_primal_dual_dist_matches_local(mesh8, positivity):
    """positivity=2 is the ADVICE r3 regression: its any-band mask must
    be reduced over the 'band' MESH axis (each shard only sees local
    bands), so band-varying amplitudes would silently diverge from the
    single-device solver without the psum."""
    nband, nx, ny = 8, 32, 32
    psf, psfhat, lastsize = _psf_setup(nband, nx, ny)
    rng = np.random.default_rng(3)
    model = np.zeros((nband, nx, ny))
    amp = 1.0 + 0.25 * np.arange(nband)
    model[:, 10, 12] = 1.5 * amp
    model[:, 20, 8] = 2.0 * amp[::-1]

    psi = make_psi(nx, ny, ("self", "db1"), 2)
    nbasis = psi.nbasis
    hess = make_psf_convolve(jnp.asarray(psfhat), lastsize)
    data = hess(jnp.asarray(model))
    L, _ = power_method(hess, (nband, nx, ny), tol=1e-8, maxit=200,
                        dtype=jnp.float64)
    L = float(L) * 1.05
    lam = 1e-3

    def grad(x):
        return hess(x) - data

    psiH_fn = lambda x: psi_dot(x, psi)
    psi_fn = lambda a: psi_hdot(a, psi)
    v0 = jnp.zeros((nband, nbasis, psi.Nymax, psi.Nxmax))
    w = jnp.ones((nbasis, psi.Nymax, psi.Nxmax))
    x0 = jnp.zeros((nband, nx, ny))
    x_local, v_local, _, _ = primal_dual(x0, v0, lam, psiH_fn, psi_fn,
                                         L, w, grad, nu=nbasis,
                                         tol=1e-7, maxit=300,
                                         positivity=positivity)

    sh = band_sharding(mesh8)
    csh = jax.sharding.NamedSharding(
        mesh8, jax.sharding.PartitionSpec("band", None, None, None))
    pd = primal_dual_dist(mesh8, psi, lastsize, nu=nbasis, tol=1e-7,
                          maxit=300, positivity=positivity)
    x_dist, v_dist, _, _ = pd(
        jax.device_put(x0, sh), jax.device_put(v0, csh),
        jax.device_put(data, sh),
        jax.device_put(jnp.asarray(psfhat), sh),
        w, jnp.asarray(lam), jnp.asarray(L))
    assert_allclose(np.asarray(x_dist), np.asarray(x_local),
                    rtol=1e-8, atol=1e-10)
    assert_allclose(np.asarray(v_dist), np.asarray(v_local),
                    rtol=1e-8, atol=1e-10)


def test_hessian_space_dist_fft_matches_local():
    """Distributed-rFFT2 convolution (band x space mesh, all_to_all
    transposes) agrees with the single-program convolve to f64 — the
    scalable spatial sharding of SURVEY.md section 5."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pfb_tpu.parallel.dist import (hessian_psf_space_dist,
                                       prep_psfhat_space)

    nband, nx, ny = 2, 32, 48
    nxp, nyp = 2 * nx, 2 * ny
    xg = np.arange(nxp) - nxp // 2
    yg = np.arange(nyp) - nyp // 2
    xx, yy = np.meshgrid(xg, yg, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nxp // 2, nyp // 2] += 0.5
    psfhat = np.asarray(make_psfhat(jnp.asarray(psf)))
    lastsize = nyp

    mesh = make_mesh(nband=2, nspace=4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(nband, nx, ny))

    for sigmainv in (0.0, 0.7):
        hess = make_psf_convolve(jnp.asarray(psfhat), lastsize,
                                 sigmainv=sigmainv)
        ref = np.asarray(hess(jnp.asarray(x)))

        php = prep_psfhat_space(jnp.asarray(psfhat), 4)
        xd = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P("band", "space")))
        phd = jax.device_put(php,
                             NamedSharding(mesh,
                                           P("band", None, "space")))
        for method in ("fft", "allgather"):
            ph_in = phd if method == "fft" else jax.device_put(
                jnp.asarray(psfhat),
                NamedSharding(mesh, P("band")))
            hd = hessian_psf_space_dist(mesh, lastsize,
                                        sigmainv=sigmainv,
                                        method=method)
            out = np.asarray(hd(xd, ph_in))
            assert_allclose(out, ref, rtol=1e-11, atol=1e-11)


def test_fluxmop_space_shards_matches_local(tmp_path):
    """fluxmop --space-shards (band+space-sharded distributed-rFFT2
    PCG forward step) reproduces the single-program solve (SURVEY.md
    section 2.9.8 spatial sharding, now reachable from a worker)."""
    from pfb_tpu.utils.ms import simulate_ms
    from pfb_tpu.workers.fluxmop import _fluxmop
    from pfb_tpu.workers.grid import _grid
    from pfb_tpu.workers.init import _init

    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=7, ntime=4, nchan=2, nsource=2, fov_deg=0.2,
                seed=11, gains=False)
    xds = _init(ms=ms, output_filename=str(tmp_path / "o"),
                channels_per_image=1, write=False)
    dds = _grid(xdsi=xds, output_filename=None, suffix="main",
                nx=64, ny=64, field_of_view=0.2, robustness=0.0,
                psf=True, residual=False, write=False)
    kwargs = dict(output_filename=None, use_psf=True, sigmainv=1e-4,
                  gamma=0.9, cg_maxit=60, verbose=0, write=False)
    m_ref, r_ref = _fluxmop(ddsi=[dict(d) for d in dds], **kwargs)
    m_sp, r_sp = _fluxmop(ddsi=[dict(d) for d in dds],
                          space_shards=4, **kwargs)
    assert_allclose(m_sp, m_ref, rtol=1e-8,
                    atol=1e-10 * np.abs(m_ref).max())
    assert_allclose(r_sp, r_ref, rtol=1e-8,
                    atol=1e-10 * np.abs(r_ref).max())


@pytest.mark.parametrize("psi_method", ["halo", "gather"])
def test_primal_dual_space_dist_matches_local(psi_method):
    """Band+space-sharded primal-dual agrees with the single-program
    solver to f64 — including through a reweight-on-converge restart —
    for BOTH space-sharded dictionaries: the halo-exchange Psi
    (parallel/dwt_halo.py, compute/comms ~1/nspace) and the gather
    fallback."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pfb_tpu.parallel.dist import (prep_psfhat_space,
                                       primal_dual_space_dist)
    from pfb_tpu.opt.primal_dual import l1reweight_func

    nband, nx, ny = 2, 32, 32
    psf, psfhat, lastsize = _psf_setup(nband, nx, ny)
    model = np.zeros((nband, nx, ny))
    model[:, 10, 12] = 1.5
    model[:, 20, 8] = 2.0

    psi = make_psi(nx, ny, ("self", "db1", "db2"), 2)
    nbasis = psi.nbasis
    hess = make_psf_convolve(jnp.asarray(psfhat), lastsize)
    data = hess(jnp.asarray(model))
    L, _ = power_method(hess, (nband, nx, ny), tol=1e-8, maxit=200,
                        dtype=jnp.float64)
    L = float(L) * 1.05
    lam = 1e-3

    def grad(x):
        return hess(x) - data

    psiH_fn = lambda x: psi_dot(x, psi)
    psi_fn = lambda a: psi_hdot(a, psi)
    v0 = jnp.zeros((nband, nbasis, psi.Nymax, psi.Nxmax))
    w = jnp.ones((nbasis, psi.Nymax, psi.Nxmax))
    rms_comps = jnp.full((nbasis, psi.Nymax, psi.Nxmax), 0.3)
    x0 = jnp.zeros((nband, nx, ny))

    mesh = make_mesh(nband=2, nspace=4)
    php = prep_psfhat_space(jnp.asarray(psfhat), 4)
    cube_sh = NamedSharding(mesh, P("band", "space", None))
    pd = primal_dual_space_dist(mesh, psi, lastsize, nu=nbasis,
                                tol=1e-7, maxit=300, positivity=1,
                                psi_method=psi_method)

    for do_rw in (False, True):
        x_local, v_local, w_local, _ = primal_dual(
            x0, v0, lam, psiH_fn, psi_fn, L, w, grad, nu=nbasis,
            tol=1e-7, maxit=300, positivity=1,
            reweighter=(
                (lambda xk: l1reweight_func(
                    psiH_fn, 1.0, rms_comps, xk, 4.0))
                if do_rw else None))

        x_dist, v_dist, w_dist, _ = pd(
            jax.device_put(x0, cube_sh), v0,
            jax.device_put(data, cube_sh),
            jax.device_put(php, NamedSharding(
                mesh, P("band", None, "space"))),
            w, jnp.asarray(lam), jnp.asarray(L),
            rms_comps=rms_comps, do_reweight=do_rw)
        assert_allclose(np.asarray(x_dist), np.asarray(x_local),
                        rtol=1e-8, atol=1e-10)
        assert_allclose(np.asarray(v_dist), np.asarray(v_local),
                        rtol=1e-8, atol=1e-10)
        assert_allclose(np.asarray(w_dist), np.asarray(w_local),
                        rtol=1e-8, atol=1e-10)
