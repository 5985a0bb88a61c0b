"""Jones-corrected Stokes visibilities and weights.

The reference derives, per Stokes product and polarisation basis, the
weighted data and weight expressions

    W = T.H M.H Sinv M T          (Stokes-space inverse covariance)
    C = W^{-1} T.H M.H Sinv V     (corrected Stokes coherency)

with M = Gp (x) conj(Gq), symbolically with sympy and numba-compiles
them per (row, chan) (pfb/utils/stokes.py:13-232). Here the same
algebra is evaluated numerically in jax.numpy over every (row, chan)
at once: W^{-1} = T^{-1} M^{-1} S M^{-H} T^{-H} with M^{-1} =
Gp^{-1} (x) conj(Gq)^{-1} from closed-form 2x2 inverses, so

    C = T^{-1} M^{-1} V,   W_ii = sum_k w_k |(M T)_ki|^2

(the weights cancel from C exactly, as they do in the reference's
simplified expressions).

Jones layout follows QuartiCal like the reference: diag mode jones has
shape (ntime, nant, nchan, ndir, 2); full mode (..., 2, 2) flattened to
4 correlations (gain_axes, utils/stokes2vis.py upstream).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_PRODUCTS = {"I": 0, "Q": 1, "U": 2, "V": 3}

# coherency <- Stokes: V = T S for the correlation order
# (00, 01, 10, 11)
_T = {"linear": np.array([[1.0, 1.0, 0, 0],
                          [0, 0, 1.0, 1.0j],
                          [0, 0, 1.0, -1.0j],
                          [1.0, -1.0, 0, 0]]),
      "circular": np.array([[1.0, 0, 0, 1.0],
                            [0, 1.0, 1.0j, 0],
                            [0, 1.0, -1.0j, 0],
                            [1.0, 0, 0, -1.0]])}


def _inv2(g):
    """Closed-form inverse of a (..., 2, 2) stack."""
    a, b = g[..., 0, 0], g[..., 0, 1]
    c, d = g[..., 1, 0], g[..., 1, 1]
    det = a * d - b * c
    return jnp.stack([jnp.stack([d, -b], -1),
                      jnp.stack([-c, a], -1)], -2) / det[..., None, None]


def _kron2(a, b):
    """Batched Kronecker product of (..., 2, 2) stacks -> (..., 4, 4)."""
    k = a[..., :, None, :, None] * b[..., None, :, None, :]
    return k.reshape(k.shape[:-4] + (4, 4))


def stokes_funcs(product="I", pol="linear", mode="diag"):
    """Return (vis_fn, wgt_fn) operating elementwise on arrays.

    diag mode:
        wgt_fn(gp0, gp1, gq0, gq1, w0, w1, w2, w3) -> real weight
        vis_fn(gp0, gp1, gq0, gq1, w0, w1, w2, w3,
               v00, v01, v10, v11) -> complex corrected Stokes vis
    full mode: gp/gq take all four complex entries (00, 01, 10, 11).

    Same algebra as the reference (pfb/utils/stokes.py:13-70).
    """
    if pol not in _T:
        raise ValueError(f"Unknown pol basis {pol}")
    if mode not in ("diag", "full"):
        raise ValueError(f"Unknown jones mode {mode}")
    i = _PRODUCTS[product]
    T = _T[pol]
    Ti = np.linalg.inv(T)
    ng = 2 if mode == "diag" else 4
    hi = lax.Precision.HIGHEST

    def gains(g):
        if mode == "diag":
            z = jnp.zeros_like(g[0])
            return jnp.stack([jnp.stack([g[0], z], -1),
                              jnp.stack([z, g[1]], -1)], -2)
        return jnp.stack([jnp.stack([g[0], g[1]], -1),
                          jnp.stack([g[2], g[3]], -1)], -2)

    def wgt_fn(*args):
        gp, gq = gains(args[:ng]), gains(args[ng:2 * ng])
        w = jnp.stack(args[2 * ng:2 * ng + 4], -1)
        A = jnp.einsum("...kl,l->...k", _kron2(gp, jnp.conj(gq)),
                       jnp.asarray(T[:, i], jnp.result_type(gp)),
                       precision=hi)
        return jnp.sum(w * jnp.abs(A) ** 2, axis=-1)

    def vis_fn(*args):
        gp, gq = gains(args[:ng]), gains(args[ng:2 * ng])
        v = jnp.stack(args[2 * ng + 4:2 * ng + 8], -1)
        Minv = _kron2(_inv2(gp), _inv2(jnp.conj(gq)))
        u = jnp.einsum("...kl,...l->...k", Minv, v, precision=hi)
        return jnp.einsum("l,...l->...",
                          jnp.asarray(Ti[i], jnp.result_type(u)), u,
                          precision=hi)

    return vis_fn, wgt_fn


@partial(jax.jit, static_argnames=("product", "pol", "mode"))
def weight_data(data, weight, flag, jones, tbin_map, ant1, ant2,
                product="I", pol="linear", mode="diag"):
    """Vectorised Jones-corrected Stokes visibilities + weights.

    data:   (nrow, nchan, ncorr) complex, ncorr in {1, 2, 4}
    weight: (nrow, nchan, ncorr) real
    flag:   (nrow, nchan) bool/int (True = flagged)
    jones:  (ntime, nant, nchan, ndir, 2) complex for diag mode
    tbin_map: (nrow,) time-bin index per row
    ant1/ant2: (nrow,)

    Returns (vis, wgt) each (nrow, nchan) — the JAX equivalent of
    _weight_data (pfb/utils/weighting.py:298-350).
    """
    ncorr = data.shape[-1]

    gp = jones[tbin_map, ant1, :, 0, :]  # (nrow, nchan, 2) diag
    gq = jones[tbin_map, ant2, :, 0, :]

    if ncorr == 1:
        # single-corr product (reference pfb/utils/correlations.py:
        # 220-234): scalar gains, measurement v = gp * C * conj(gq).
        # ML estimate C = v / (gp conj(gq)), weight = W |gp|^2 |gq|^2
        # — the reference's vis_func/wgt_func pair with the corrected
        # (weight-normalised) convention the other branches use.
        if product != "I":
            raise ValueError("single-corr data holds only product I")
        g_p, g_q = gp[..., 0], gq[..., 0]
        w0 = weight[..., 0]
        a2 = jnp.real(g_p * jnp.conj(g_p) * g_q * jnp.conj(g_q))
        wgt = w0 * a2
        vis = data[..., 0] * jnp.conj(g_p) * g_q / jnp.where(
            a2 > 0, a2, 1.0)
        ok = (flag == 0) & (a2 > 0)
        return jnp.where(ok, vis, 0.0), jnp.where(ok, wgt, 0.0)

    vfn, wfn = stokes_funcs(product, pol, mode)

    if ncorr == 4:
        w = [weight[..., 0], weight[..., 1], weight[..., 2],
             weight[..., 3]]
        v = [data[..., 0], data[..., 1], data[..., 2], data[..., 3]]
    elif ncorr == 2:
        one = jnp.ones_like(weight[..., 0])
        zero = jnp.zeros_like(data[..., 0])
        w = [weight[..., 0], one, one, weight[..., -1]]
        v = [data[..., 0], zero, zero, data[..., -1]]
    else:
        raise ValueError(f"ncorr={ncorr} not supported")

    if mode == "diag":
        gargs = (gp[..., 0], gp[..., 1], gq[..., 0], gq[..., 1])
    else:
        gargs = (gp[..., 0], gp[..., 1], gp[..., 2], gp[..., 3],
                 gq[..., 0], gq[..., 1], gq[..., 2], gq[..., 3])

    wgt = jnp.real(wfn(*gargs, *w))
    vis = vfn(*gargs, *w, *v)
    ok = (flag == 0)
    return jnp.where(ok, vis, 0.0), jnp.where(ok, wgt, 0.0)


def unity_jones(ntime, nant, nchan):
    """Identity diag Jones (no gain corruption)."""
    return np.ones((ntime, nant, nchan, 1, 2), dtype=np.complex128)
