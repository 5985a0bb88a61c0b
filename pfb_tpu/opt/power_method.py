"""Power method for the spectral norm of the Hessian approximation.

Reference: pfb/opt/power_method.py:11-49. Used to set the primal-dual
step sizes (L = hessnorm). Implemented as a lax.while_loop so the whole
iteration runs on-device.
"""

import jax
import jax.numpy as jnp
from jax import lax


def power_method(A, imsize, b0=None, tol=1e-5, maxit=250, key=None,
                 dtype=jnp.float32, verbosity=0, report_freq=100):
    """Dominant eigenvalue (and eigenvector) of the symmetric operator A.

    Matches the reference iteration: b <- A(b_prev); beta = <b_prev, b> /
    <b_prev, b_prev>; b <- b/|b|; eps = |beta - beta_prev| / beta_prev.
    Warm-startable via b0 (reference power_method.py:20-23).
    """
    if b0 is None:
        if key is None:
            key = jax.random.PRNGKey(42)
        b = jax.random.normal(key, imsize, dtype=dtype)
    else:
        b = b0.astype(dtype) if b0.dtype != dtype else b0
    b = b / jnp.linalg.norm(b)

    one = jnp.asarray(1.0, dtype)

    def cond(state):
        b, bp, beta, eps, k = state
        return (eps > tol) & (k < maxit)

    def body(state):
        b, bp, beta, eps, k = state
        bnew = A(bp)
        bnorm = jnp.linalg.norm(bnew)
        betap = beta
        beta = jnp.vdot(bp, bnew).real / jnp.vdot(bp, bp).real
        bnew = bnew / bnorm
        eps = jnp.abs(beta - betap) / betap
        from pfb_tpu.opt.pcg import _progress
        _progress("pm", k, eps, report_freq, verbosity)
        return bnew, bnew, beta, eps, k + 1

    state0 = (b, b, one, one, jnp.asarray(0, jnp.int32))
    b, bp, beta, eps, k = lax.while_loop(cond, body, state0)
    from pfb_tpu.opt.pcg import _summary
    _summary("pm", k, eps, verbosity)
    return beta, b


def make_power_method_fused(apply, tol=1e-5, maxit=250, verbosity=0,
                            report_freq=100):
    """Jit :func:`power_method` around ``apply(x, consts)`` with the
    operator constants as runtime arguments (see
    opt/pcg.py:make_pcg_bands_fused for why): ``pm(b0, consts)``
    returns (beta, b). Used for the PSF Hessian, whose transfer
    function must not be baked into the program."""

    @jax.jit
    def pm(b0, consts):
        # align with the operator's output dtype — the while_loop
        # carry must be dtype-stable
        out_dt = jax.eval_shape(lambda z: apply(z, consts), b0).dtype
        return power_method(lambda z: apply(z, consts), b0.shape,
                            b0=b0.astype(out_dt), tol=tol,
                            maxit=maxit, verbosity=verbosity,
                            report_freq=report_freq, dtype=out_dt)

    return pm
