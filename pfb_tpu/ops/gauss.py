"""Gaussian-process operator: squared-exponential FFT convolution and
Kronecker covariance matvecs.

Equivalent of pfb/operators/gauss.py + the kron helpers in
pfb/utils/misc.py:63-93 — used by the fwdbwd nonlinear parametrisation
(correlated log-normal fields)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def make_kernel(nx_psf, ny_psf, sigma0, length_scale):
    """Squared-exponential kernel image centred on the padded grid
    (reference gauss.py make_kernel)."""
    v = np.arange(-nx_psf // 2, nx_psf // 2)
    u = np.arange(-ny_psf // 2, ny_psf // 2)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    return (sigma0**2 * np.exp(-(uu**2 + vv**2) /
                               (2 * length_scale**2)))


def sq_exp_kernel(x, xp, sigmaf, l):
    """Squared-exponential covariance matrix K(x, x')."""
    xx = np.abs(x[:, None] - xp[None, :])
    return sigmaf**2 * np.exp(-xx**2 / (2 * l**2))


@jax.jit
def kron_matvec(A, b):
    """(A[0] kron A[1] kron ...) b without forming the product
    (reference misc.py:63-74). A is a tuple of square matrices."""
    x = b.reshape(-1)
    N = x.size
    for Ad in A:
        Gd = Ad.shape[0]
        X = x.reshape(Gd, N // Gd)
        x = jnp.matmul(Ad, X, precision=jax.lax.Precision.HIGHEST
                       ).T.reshape(-1)
    return x.reshape(b.shape)


class Gauss:
    """FFT convolution with a squared-exponential kernel + Kronecker
    (band x X x Y) covariance matvec/inverse
    (reference: pfb/operators/gauss.py:11-115)."""

    def __init__(self, sigma0, nband, nx, ny, length_scale=1.0):
        self.nband, self.nx, self.ny = nband, nx, ny
        nx_psf = 2 * nx
        ny_psf = 2 * ny
        kern = make_kernel(nx_psf, ny_psf, sigma0, length_scale)
        from pfb_tpu.ops.fft import make_psfhat
        self.khat = make_psfhat(jnp.asarray(kern[None]))
        self.lastsize = ny_psf

        # Kronecker factors for the covariance
        tb = np.arange(nband) / max(nband - 1, 1) if nband > 1 else \
            np.zeros(1)
        tx = np.arange(nx) / (nx - 1)
        ty = np.arange(ny) / (ny - 1)
        self.Kv = sq_exp_kernel(tb, tb, sigma0, 0.25) + \
            1e-10 * np.eye(nband)
        self.Kx = sq_exp_kernel(tx, tx, 1.0, length_scale / nx) + \
            1e-10 * np.eye(nx)
        self.Ky = sq_exp_kernel(ty, ty, 1.0, length_scale / ny) + \
            1e-10 * np.eye(ny)
        self.K = (jnp.asarray(self.Kv), jnp.asarray(self.Kx),
                  jnp.asarray(self.Ky))
        self.Kinv = tuple(jnp.asarray(np.linalg.inv(np.asarray(Kd)))
                          for Kd in self.K)
        self.L = tuple(jnp.asarray(np.linalg.cholesky(np.asarray(Kd)))
                       for Kd in self.K)

    def convolve(self, x):
        """FFT convolution with the SE kernel (per band)."""
        from pfb_tpu.ops.fft import psf_convolve_cube
        khat = jnp.broadcast_to(self.khat,
                                (x.shape[0],) + self.khat.shape[1:])
        return psf_convolve_cube(x, khat, self.lastsize)

    def dot(self, x):
        """Covariance matvec K x (Kronecker)."""
        return kron_matvec(self.K, x)

    def idot(self, x):
        """Inverse covariance matvec K^-1 x."""
        return kron_matvec(self.Kinv, x)

    def sqrtdot(self, xi):
        """Sample transform L xi with K = L L.T."""
        return kron_matvec(self.L, xi)
