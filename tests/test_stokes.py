"""Jones-corrected Stokes visibility tests (diag + full 2x2 modes).

The reference's sympy derivation (pfb/utils/stokes.py:13-70) is the
spec; corrupting model visibilities with known Jones terms and running
weight_data must recover the Stokes-I model to machine precision."""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pfb_tpu.utils.stokes import stokes_funcs, unity_jones, weight_data


def _setup(seed=0, nrow=16, nchan=2, nant=4, ntime=2):
    rng = np.random.default_rng(seed)
    I = rng.random((nrow, nchan))
    weight = np.ones((nrow, nchan, 4))
    flag = np.zeros((nrow, nchan), np.uint8)
    ant1 = rng.integers(0, nant, nrow)
    ant2 = rng.integers(0, nant, nrow)
    tbin = rng.integers(0, ntime, nrow)
    return rng, I, weight, flag, ant1, ant2, tbin, nant, ntime


def test_diag_jones_correction_exact():
    rng, I, weight, flag, ant1, ant2, tbin, nant, ntime = _setup()
    nrow, nchan = I.shape
    jones = (1 + 0.1 * rng.standard_normal((ntime, nant, nchan, 1, 2))) \
        * np.exp(1j * 0.2 * rng.standard_normal(
            (ntime, nant, nchan, 1, 2)))
    data = np.zeros((nrow, nchan, 4), complex)
    gp = jones[tbin, ant1, :, 0, :]
    gq = jones[tbin, ant2, :, 0, :]
    data[..., 0] = gp[..., 0] * np.conj(gq[..., 0]) * I
    data[..., 3] = gp[..., 1] * np.conj(gq[..., 1]) * I
    vis, wgt = weight_data(jnp.asarray(data), jnp.asarray(weight),
                           jnp.asarray(flag), jnp.asarray(jones),
                           jnp.asarray(tbin), jnp.asarray(ant1),
                           jnp.asarray(ant2))
    assert_allclose(np.asarray(vis), I, atol=1e-12)
    assert (np.asarray(wgt) > 0).all()


def test_full_jones_correction_exact():
    rng, I, weight, flag, ant1, ant2, tbin, nant, ntime = _setup(1)
    nrow, nchan = I.shape
    g = 1 + 0.1 * rng.standard_normal((ntime, nant, nchan, 1, 4)) + \
        1j * 0.05 * rng.standard_normal((ntime, nant, nchan, 1, 4))
    jones = np.zeros((ntime, nant, nchan, 1, 4), complex)
    jones[..., 0] = g[..., 0]
    jones[..., 3] = g[..., 3]
    jones[..., 1] = 0.05 * g[..., 1]  # off-diagonal leakage
    jones[..., 2] = 0.05 * g[..., 2]
    B = np.zeros((nrow, nchan, 2, 2), complex)
    B[..., 0, 0] = I
    B[..., 1, 1] = I
    gp = jones[tbin, ant1, :, 0, :].reshape(nrow, nchan, 2, 2)
    gq = jones[tbin, ant2, :, 0, :].reshape(nrow, nchan, 2, 2)
    V = np.einsum("rcij,rcjk,rclk->rcil", gp, B, gq.conj())
    vis, wgt = weight_data(jnp.asarray(V.reshape(nrow, nchan, 4)),
                           jnp.asarray(weight), jnp.asarray(flag),
                           jnp.asarray(jones), jnp.asarray(tbin),
                           jnp.asarray(ant1), jnp.asarray(ant2),
                           mode="full")
    assert_allclose(np.asarray(vis), I, atol=1e-12)


def test_flagged_rows_zeroed():
    rng, I, weight, flag, ant1, ant2, tbin, nant, ntime = _setup(2)
    nrow, nchan = I.shape
    flag[::2] = 1
    data = np.zeros((nrow, nchan, 4), complex)
    data[..., 0] = I
    data[..., 3] = I
    jones = unity_jones(ntime, nant, nchan)
    vis, wgt = weight_data(jnp.asarray(data), jnp.asarray(weight),
                           jnp.asarray(flag), jnp.asarray(jones),
                           jnp.asarray(tbin), jnp.asarray(ant1),
                           jnp.asarray(ant2))
    assert np.all(np.asarray(vis)[::2] == 0)
    assert np.all(np.asarray(wgt)[::2] == 0)


def test_stokes_products_QUV():
    """Each product's corrected vis equals the corresponding Stokes
    component for unity Jones (linear basis: XX=I+Q, XY=U+iV,
    YX=U-iV, YY=I-Q)."""
    rng = np.random.default_rng(3)
    nrow, nchan = 8, 2
    I, Q, U, V = (rng.random((nrow, nchan)) for _ in range(4))
    data = np.zeros((nrow, nchan, 4), complex)
    data[..., 0] = I + Q
    data[..., 1] = U + 1j * V
    data[..., 2] = U - 1j * V
    data[..., 3] = I - Q
    weight = np.ones((nrow, nchan, 4))
    flag = np.zeros((nrow, nchan), np.uint8)
    jones = unity_jones(1, 2, nchan)
    z = np.zeros(nrow, int)
    o = np.ones(nrow, int)
    for prod, truth in (("I", I), ("Q", Q), ("U", U), ("V", V)):
        vis, wgt = weight_data(jnp.asarray(data), jnp.asarray(weight),
                               jnp.asarray(flag), jnp.asarray(jones),
                               jnp.asarray(z), jnp.asarray(z),
                               jnp.asarray(o), product=prod)
        assert_allclose(np.asarray(vis), truth, atol=1e-12,
                        err_msg=prod)


def test_single_corr_correction_exact():
    """ncorr==1 path (reference pfb/utils/correlations.py:220-234):
    scalar-gain corrupted single-corr data recovers the model and the
    weight is W |gp|^2 |gq|^2."""
    rng, I, weight, flag, ant1, ant2, tbin, nant, ntime = _setup(3)
    nrow, nchan = I.shape
    jones = (1 + 0.1 * rng.standard_normal((ntime, nant, nchan, 1, 2))) \
        * np.exp(1j * 0.2 * rng.standard_normal(
            (ntime, nant, nchan, 1, 2)))
    gp = jones[tbin, ant1, :, 0, 0]
    gq = jones[tbin, ant2, :, 0, 0]
    data = (gp * np.conj(gq) * I)[..., None]
    w0 = rng.random((nrow, nchan, 1)) + 0.5
    flag[3, :] = 1
    vis, wgt = weight_data(jnp.asarray(data), jnp.asarray(w0),
                           jnp.asarray(flag), jnp.asarray(jones),
                           jnp.asarray(tbin), jnp.asarray(ant1),
                           jnp.asarray(ant2))
    vis, wgt = np.asarray(vis), np.asarray(wgt)
    keep = flag == 0
    assert_allclose(vis[keep], I[keep], atol=1e-12)
    wexp = w0[..., 0] * np.abs(gp) ** 2 * np.abs(gq) ** 2
    assert_allclose(wgt[keep], wexp[keep], atol=1e-12)
    assert (vis[~keep] == 0).all() and (wgt[~keep] == 0).all()


@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("pol", ["linear", "circular"])
@pytest.mark.parametrize("product", ["I", "Q", "U", "V"])
def test_stokes_algebra_vs_numpy_kron(product, pol, mode):
    """The jnp Stokes algebra equals an independent numpy evaluation
    of W = T^H M^H S^-1 M T and C = W^-1 T^H M^H S^-1 V with
    M = Gp (x) conj(Gq) (np.kron, np.linalg.inv) per sample."""
    rng = np.random.default_rng(
        ["I", "Q", "U", "V"].index(product) * 4
        + ["linear", "circular"].index(pol) * 2
        + ["diag", "full"].index(mode))
    n = 6

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    gp = np.eye(2) + 0.2 * cplx(n, 2, 2)
    gq = np.eye(2) + 0.2 * cplx(n, 2, 2)
    if mode == "diag":
        gp *= np.eye(2)
        gq *= np.eye(2)
    w = 0.5 + rng.random((n, 4))
    v = cplx(n, 4)
    T = {"linear": np.array([[1, 1, 0, 0], [0, 0, 1, 1j],
                             [0, 0, 1, -1j], [1, -1, 0, 0]]),
         "circular": np.array([[1, 0, 0, 1], [0, 1, 1j, 0],
                               [0, 1, -1j, 0], [1, 0, 0, -1]])}[pol]
    i = "IQUV".index(product)
    wref = np.zeros(n)
    cref = np.zeros(n, complex)
    for s in range(n):
        M = np.kron(gp[s], gq[s].conj())
        Sinv = np.diag(w[s])
        W = T.conj().T @ M.conj().T @ Sinv @ M @ T
        C = np.linalg.inv(W) @ T.conj().T @ M.conj().T @ Sinv @ v[s]
        wref[s] = W[i, i].real
        cref[s] = C[i]
    vfn, wfn = stokes_funcs(product, pol, mode)
    if mode == "diag":
        gargs = (gp[:, 0, 0], gp[:, 1, 1], gq[:, 0, 0], gq[:, 1, 1])
    else:
        gargs = tuple(gp[:, a, b] for a in range(2) for b in range(2)) \
            + tuple(gq[:, a, b] for a in range(2) for b in range(2))
    gargs = tuple(jnp.asarray(g) for g in gargs)
    ws = tuple(jnp.asarray(w[:, k]) for k in range(4))
    vs = tuple(jnp.asarray(v[:, k]) for k in range(4))
    assert_allclose(np.asarray(wfn(*gargs, *ws)), wref, rtol=1e-10)
    assert_allclose(np.asarray(vfn(*gargs, *ws, *vs)), cref, rtol=1e-9,
                    atol=1e-12)
