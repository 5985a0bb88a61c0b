"""SARA wavelet dictionary Psi.

JAX re-design of pfb/operators/psi.py: the numba jitclass +
ThreadPool-over-bands becomes a pure function vmapped over the band axis;
the per-basis transforms (different packed sizes) are unrolled statically
and zero-padded into the common (nbasis, Nymax, Nxmax) coefficient cube.

Conventions copied from the reference:
- 'self' basis stores the *transposed* image (psi.py:195-199, 229-233).
- Psi is unnormalised: hdot(dot(x)) = nbasis * x
  (tests/test_psi_operator.py:47-48); the primal-dual compensates with
  nu = nbasis (workers/spotless.py:275).
- dot:  image (nband, nx, ny) -> coeffs (nband, nbasis, Nymax, Nxmax)
- hdot: coeffs -> image, summing over bases.
"""

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pfb_tpu.ops.wavelets import WaveletSpec, dwt2d, idwt2d, make_spec


@dataclass(frozen=True)
class PsiSpec:
    nx: int
    ny: int
    bases: Tuple[str, ...]
    nlevel: int
    specs: Tuple  # WaveletSpec or None (for 'self'), aligned with bases
    Nxmax: int
    Nymax: int

    @property
    def nbasis(self):
        return len(self.bases)


def make_psi(nx, ny, bases=("self", "db1", "db2"), nlevel=3) -> PsiSpec:
    """Bookkeeping for the dictionary (reference psi_band_maker,
    pfb/operators/psi.py:17-123)."""
    specs = []
    Nxmax, Nymax = 0, 0
    for w in bases:
        if w == "self":
            specs.append(None)
            Nxmax = max(Nxmax, nx)
            Nymax = max(Nymax, ny)
        else:
            s = make_spec(w, nx, ny, nlevel)
            specs.append(s)
            Nxmax = max(Nxmax, s.Ntotx)
            Nymax = max(Nymax, s.Ntoty)
    return PsiSpec(nx, ny, tuple(bases), nlevel, tuple(specs), Nxmax, Nymax)


def _psi_dot_band(x, psi: PsiSpec):
    """(nx, ny) -> (nbasis, Nymax, Nxmax)."""
    outs = []
    for w, s in zip(psi.bases, psi.specs):
        if w == "self":
            a = x.T
        else:
            a = dwt2d(x, s)
        pad = [(0, psi.Nymax - a.shape[0]), (0, psi.Nxmax - a.shape[1])]
        outs.append(jnp.pad(a, pad))
    return jnp.stack(outs)


def _psi_hdot_band(alpha, psi: PsiSpec):
    """(nbasis, Nymax, Nxmax) -> (nx, ny), sum over bases."""
    out = jnp.zeros((psi.nx, psi.ny), alpha.dtype)
    for i, (w, s) in enumerate(zip(psi.bases, psi.specs)):
        if w == "self":
            out = out + alpha[i, : psi.ny, : psi.nx].T
        else:
            out = out + idwt2d(alpha[i, : s.Ntoty, : s.Ntotx], s)
    return out


@partial(jax.jit, static_argnames=("psi",))
def psi_dot(x, psi: PsiSpec):
    """Image cube -> coefficient cube (reference Psi.dot,
    psi.py:284-296). x: (nband, nx, ny) or (nx, ny)."""
    if x.ndim == 2:
        return _psi_dot_band(x, psi)
    return jax.vmap(lambda xb: _psi_dot_band(xb, psi))(x)


@partial(jax.jit, static_argnames=("psi",))
def psi_hdot(alpha, psi: PsiSpec):
    """Coefficient cube -> image cube (reference Psi.hdot,
    psi.py:298-310). alpha: (nband, nbasis, Nymax, Nxmax) or
    (nbasis, Nymax, Nxmax)."""
    if alpha.ndim == 3:
        return _psi_hdot_band(alpha, psi)
    return jax.vmap(lambda ab: _psi_hdot_band(ab, psi))(alpha)
