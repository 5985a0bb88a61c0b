"""Primal-dual (Chambolle–Pock) solver with positivity for the SARA
backward step.

Solves  argmin_x (xbar - x).H A (xbar - x)/2 + lam ||Psi.H x||_21,
optionally s.t. x >= 0, where A is the (PSF) Hessian and Psi the SARA
dictionary.

JAX redesign of pfb/opt/primal_dual.py:91-180
(primal_dual_optimised): the whole iteration — Psi.H, fused dual update,
Psi, Hessian gradient, positivity, convergence check and in-loop
l1-reweighting — is one lax.while_loop, so a full backward step is a
single XLA program with zero host round trips (the reference pays a
numba/numexpr/Python dispatch per term per iteration).

Step sizes (reference primal_dual.py:123-129):
    sigma = L / (2 gamma) / nu
    tau   = 0.9 / (L / (2 gamma) + sigma nu^2)
with nu = nbasis for the unnormalised SARA dictionary
(workers/spotless.py:275).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from pfb_tpu.ops.prox import dual_update_21m
from pfb_tpu.opt.pcg import norm_diff


def apply_positivity(x, positivity):
    """positivity modes (reference primal_dual.py:57-61, 142-146):
    0 - none; 1 - clip negatives; 2 - zero every pixel column where any
    band is <= 0."""
    if positivity == 1:
        return jnp.maximum(x, 0.0)
    if positivity == 2:
        msk = jnp.any(x <= 0.0, axis=0, keepdims=True)
        return jnp.where(msk, 0.0, x)
    return x


def primal_dual(x,
                v,
                lam,
                psiH,            # image -> coeffs (Psi.H, i.e. psi_dot)
                psi,             # coeffs -> image (Psi, i.e. psi_hdot)
                L,
                l1weight,
                grad,            # gradient of the smooth term
                reweighter=None,  # optional x -> new l1weight
                nu=1.0,
                sigma=None,
                tol=1e-5,
                maxit=1000,
                positivity=1,
                gamma=1.0,
                maxreweight=50,
                verbosity=0,
                report_freq=50):
    """Returns (x, v, l1weight, niters).

    Matches primal_dual_optimised (pfb/opt/primal_dual.py:91-180)
    including the reweight-on-converge restart: when the relative change
    drops below tol and a reweighter is given, the l1 weights are
    refreshed (up to maxreweight times) and iteration continues.
    """
    L = jnp.asarray(L, x.dtype)
    if sigma is None:
        sigma = L / (2.0 * gamma) / nu
    else:
        sigma = jnp.asarray(sigma, x.dtype)
    tau = 0.9 / (L / (2.0 * gamma) + sigma * nu**2)
    lam = jnp.asarray(lam, x.dtype)

    def cond(state):
        xp, vp, w, nrw, eps, done, k = state
        return (~done) & (k < maxit)

    def body(state):
        xp, vp, w, nrw, eps, done, k = state
        vnew = dual_update_21m(vp, psiH(xp), lam, sigma=sigma, weight=w)
        xout = psi(2.0 * vnew - vp) + grad(xp)
        xnew = apply_positivity(xp - tau * xout, positivity)
        eps = norm_diff(xnew, xp)
        converged = eps < tol
        if reweighter is not None:
            do_rw = converged & (nrw < maxreweight)
            w = lax.cond(do_rw, lambda: reweighter(xnew), lambda: w)
            nrw = nrw + do_rw.astype(nrw.dtype)
            done = converged & ~do_rw
        else:
            done = converged
        from pfb_tpu.opt.pcg import _progress
        _progress("pd", k, eps, report_freq, verbosity)
        return xnew, vnew, w, nrw, eps, done, k + 1

    dt = jnp.result_type(x.dtype, jnp.float32)
    state0 = (x, v, l1weight, jnp.asarray(0, jnp.int32),
              jnp.asarray(1.0, dt), jnp.asarray(False),
              jnp.asarray(0, jnp.int32))
    xf, vf, wf, nrw, eps, done, k = lax.while_loop(cond, body, state0)
    from pfb_tpu.opt.pcg import _summary
    _summary("pd", k, eps, verbosity)
    return xf, vf, wf, k


def make_primal_dual_fused(apply, psiH, psi, nu, rmsfactor, alpha=4.0,
                           sigma=None, tol=1e-5, maxit=1000,
                           positivity=1, gamma=1.0, maxreweight=50,
                           verbosity=0, report_freq=50):
    """Jit the whole :func:`primal_dual` backward step around a
    Hessian of the form ``apply(x, consts)`` with the operator
    constants, the data term, the l1 weights and the coefficient rms
    as runtime arguments (see opt/pcg.py:make_pcg_bands_fused for why
    the PSFHAT must be a jit argument).

    ``solve(x, v, data, l1weight, lam, L, rms_comps, consts,
    do_reweight=...)`` returns (x, v, l1weight, niters); grad is
    ``apply(x, consts) - data`` and do_reweight toggles the in-loop
    l1-reweight restart (two compiled variants over a major cycle)."""

    @partial(jax.jit, static_argnames=("do_reweight",))
    def solve(x, v, data, l1weight, lam, L, rms_comps, consts, *,
              do_reweight=False):
        def grad(z):
            return apply(z, consts) - data

        if do_reweight:
            def reweighter(z):
                return l1reweight_func(psiH, rmsfactor, rms_comps, z,
                                       alpha)
        else:
            reweighter = None
        return primal_dual(x, v, lam, psiH, psi, L, l1weight, grad,
                           reweighter=reweighter, nu=nu, sigma=sigma,
                           tol=tol, maxit=maxit, positivity=positivity,
                           gamma=gamma, maxreweight=maxreweight,
                           verbosity=verbosity,
                           report_freq=report_freq)

    return solve


def l1reweight_func(psiH, rmsfactor, rms_comps, model, alpha=4):
    """L1 reweighting: weights stay ~1 for components well above the
    coefficient-space rms and grow toward (1+rmsfactor) for small ones
    (reference: pfb/utils/misc.py:1070-1080)."""
    outvar = psiH(model)
    mcomps = jnp.abs(jnp.sum(outvar, axis=0))
    return (1 + rmsfactor) / (1 + mcomps**alpha / rms_comps**alpha)
