"""Proximal operators for the l21 regularisers.

JAX equivalents of pfb/prox/prox_21.py and prox_21m.py — the
numba loops are trivial vectorised jnp; XLA fuses them.

Shapes: v is (nband, nbasis, nymax, nxmax); weight is
(nbasis, nymax, nxmax).
"""

import jax
import jax.numpy as jnp


def prox_21(v, sigma, weight=1.0, axis=0):
    """prox of sigma*||.||_21 with the *l2* norm over ``axis``
    (reference: pfb/prox/prox_21.py:5-23)."""
    l2_norm = jnp.linalg.norm(v, axis=axis)
    l2_soft = jnp.maximum(l2_norm - sigma * weight, 0.0)
    ratio = jnp.where(l2_norm != 0, l2_soft / jnp.where(l2_norm == 0, 1.0,
                                                        l2_norm), 0.0)
    return v * jnp.expand_dims(ratio, axis=axis)


def prox_21m(v, sigma, weight=1.0, axis=0):
    """prox of sigma*||.||_21 with the signed *band-sum* ("MFS") norm
    over ``axis`` (reference: pfb/prox/prox_21m.py:5-28)."""
    l2_norm = jnp.sum(v, axis=axis)
    l2_soft = jnp.maximum(jnp.abs(l2_norm) - sigma * weight, 0.0) * \
        jnp.sign(l2_norm)
    ratio = jnp.where(l2_norm != 0, l2_soft / jnp.where(l2_norm == 0, 1.0,
                                                        l2_norm), 0.0)
    return v * jnp.expand_dims(ratio, axis=axis)


def dual_update_21m(vp, v, lam, sigma=1.0, weight=1.0):
    """Fused dual update of the primal-dual iteration with the MFS norm:
    given v = psiH(xp) and previous dual vp, returns

        vtilde = vp + sigma*v
        v_new  = vtilde * (1 - soft(|sum_b vtilde|/sigma)/( |sum_b vtilde|/sigma ))

    (reference: pfb/prox/prox_21m.py:76-103, dual_update_numba)."""
    vtilde = vp + sigma * v
    vsum = jnp.abs(jnp.sum(vtilde, axis=0)) / sigma  # (nbasis, ny, nx)
    soft = jnp.maximum(vsum - lam * weight / sigma, 0.0)
    scale = jnp.where(vsum != 0,
                      1.0 - soft / jnp.where(vsum == 0, 1.0, vsum), 1.0)
    return vtilde * scale[None]


def dual_update_21(vp, v, lam, sigma=1.0, weight=1.0):
    """Same with the l2-over-band norm
    (reference: pfb/prox/prox_21.py:66-92)."""
    vtilde = vp + sigma * v
    vnorm = jnp.linalg.norm(vtilde, axis=0) / sigma
    soft = jnp.maximum(vnorm - lam * weight / sigma, 0.0)
    scale = jnp.where(vnorm != 0,
                      1.0 - soft / jnp.where(vnorm == 0, 1.0, vnorm), 1.0)
    return vtilde * scale[None]
