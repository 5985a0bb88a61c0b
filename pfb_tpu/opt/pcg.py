"""Conjugate-gradient solvers.

JAX redesign of the reference CG/PCG (pfb/opt/pcg.py). The
reference runs a Python loop over numpy arrays with an inner backtracking
loop; here the whole solve is a single ``lax.while_loop`` so it executes
on-device without host round trips.

Two flavours:

- :func:`pcg`       — solve a single system A x = b ("global" inner
                      products over the whole array), matching
                      pfb/opt/pcg.py:53-136 including backtracking and
                      minit semantics.
- :func:`pcg_bands` — batched per-band PCG where every band has its own
                      step sizes/convergence (the JAX equivalent of the
                      reference's dask-blockwise ``pcg_psf``,
                      pfb/opt/pcg.py:242-360). One XLA program, per-band
                      scalar lanes; converged bands freeze.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def norm_diff(x, xp):
    """Relative change sqrt(|x-xp|^2 / (1e-12 + |x|^2))
    (reference: pfb/utils/misc.py:1316-1351)."""
    num = jnp.sum((x - xp) ** 2)
    den = 1e-12 + jnp.sum(x**2)
    return jnp.sqrt(num / den)


def cg(A, b, x0=None, tol=1e-5, maxit=500):
    """Textbook CG (reference: pfb/opt/pcg.py:12-50).

    Convergence on the *absolute* residual norm ``r.r`` like the
    reference (pcg.py:43 uses eps = rnorm, not rnorm/rnorm0).
    """
    if x0 is None:
        x = jnp.zeros_like(b)
    else:
        x = x0

    r0 = A(x) - b
    p0 = -r0
    rnorm0 = jnp.vdot(r0, r0).real

    def cond(state):
        x, r, p, rnorm, k = state
        return (rnorm > tol) & (k < maxit)

    def body(state):
        x, r, p, rnorm, k = state
        Ap = A(p)
        alpha = rnorm / jnp.vdot(p, Ap).real
        x = x + alpha * p
        r = r + alpha * Ap
        rnorm_next = jnp.vdot(r, r).real
        beta = rnorm_next / rnorm
        p = beta * p - r
        return x, r, p, rnorm_next, k + 1

    x, r, p, rnorm, k = lax.while_loop(cond, body, (x, r0, p0, rnorm0, 0))
    return x


def _progress(name, k, eps, report_freq, verbosity):
    """In-loop convergence reporting for the fused solvers
    (reference per-iteration prints, pfb/opt/pcg.py:120-132): a
    jax.debug.print every ``report_freq`` iterations when
    verbosity >= 2 — not traced at all below that, so the default
    single-XLA-program solvers stay print-free."""
    if verbosity < 2 or not report_freq:
        return
    lax.cond(
        (k % report_freq) == 0,
        lambda: jax.debug.print(
            name + ": iter {k}  eps {e:.3e}", k=k, e=jnp.max(eps)),
        lambda: None)


def _summary(name, k, eps, verbosity):
    """End-of-solve summary (verbosity >= 1)."""
    if verbosity < 1:
        return
    jax.debug.print(name + ": done at iter {k}  eps {e:.3e}",
                    k=k, e=jnp.max(eps))


def pcg(A, b, x0=None, M=None, tol=1e-5, maxit=500, minit=100,
        backtrack=True, return_resid=False, verbosity=0,
        report_freq=10, name="pcg"):
    """PCG with preconditioner M, minimum iterations and a backtracking
    "line search" that shrinks alpha by 0.75 while the (preconditioned)
    residual norm increases (reference: pfb/opt/pcg.py:53-136).

    Convergence criterion is the relative change in x (norm_diff), with at
    least ``minit`` iterations, exactly like the reference.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if M is None:
        M = lambda v: v

    r = A(x0) - b
    y = M(r)
    p = -y

    def cond(state):
        x, r, y, p, eps, k = state
        return ((eps > tol) | (k < minit)) & (k < maxit)

    def body(state):
        x, r, y, p, eps, k = state
        xp = x
        rp = r
        Ap = A(p)
        rnorm = jnp.vdot(r, y).real
        pAp = jnp.vdot(p, Ap).real
        # guard the exactly-converged case (r = p = 0 when minit
        # forces iterations past convergence): 0/0 would poison x
        alpha0 = jnp.where(pAp != 0,
                           rnorm / jnp.where(pAp == 0, 1.0, pAp), 0.0)

        def bt_cond(bt_state):
            alpha, x_, r_, y_, rnn = bt_state
            return rnn > rnorm

        def bt_body(bt_state):
            alpha, x_, r_, y_, rnn = bt_state
            alpha = alpha * 0.75
            x_ = xp + alpha * p
            r_ = rp + alpha * Ap
            y_ = M(r_)
            rnn = jnp.vdot(r_, y_).real
            return alpha, x_, r_, y_, rnn

        x = xp + alpha0 * p
        r = rp + alpha0 * Ap
        y = M(r)
        rnorm_next = jnp.vdot(r, y).real
        if backtrack:
            _, x, r, y, rnorm_next = lax.while_loop(
                bt_cond, bt_body, (alpha0, x, r, y, rnorm_next))

        beta = jnp.where(rnorm != 0,
                         rnorm_next / jnp.where(rnorm == 0, 1.0,
                                                rnorm), 0.0)
        p = beta * p - y
        eps = norm_diff(x, xp)
        _progress(name, k, eps, report_freq, verbosity)
        return x, r, y, p, eps, k + 1

    dt = jnp.result_type(b.dtype, jnp.float32)
    state0 = (x0, r, y, p, jnp.asarray(1.0, dt), jnp.asarray(0, jnp.int32))
    x, r, y, p, eps, k = lax.while_loop(cond, body, state0)
    _summary(name, k, eps, verbosity)
    if return_resid:
        return x, r
    return x


def _band_vdot(a, b):
    """Per-band real inner product over trailing (nx, ny) axes."""
    return jnp.sum(a * b, axis=(-2, -1), keepdims=True)


def pcg_bands(A, b, x0=None, M=None, tol=1e-5, maxit=500, minit=100,
              backtrack=True, verbosity=0, report_freq=10,
              name="pcg"):
    """Batched per-band PCG: solve nband independent systems in one XLA
    program, with per-band alpha/beta/backtracking and per-band
    convergence freezing.

    ``A`` must act band-wise on a (nband, nx, ny) cube (e.g. the PSF
    Hessian), which makes this mathematically identical to the
    reference's per-band loop in ``_pcg_psf_impl``
    (pfb/opt/pcg.py:242-291) while keeping the device busy on the full
    cube.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    has_M = M is not None
    if M is None:
        M = lambda v: v

    r = A(x0) - b
    y = M(r)
    p = -y
    dt = jnp.result_type(b.dtype, jnp.float32)
    rnorm0 = _band_vdot(r, y)

    if tol <= 0:
        # fixed-iteration mode (throughput path: the fused-solver
        # bench, shard_map inner solves): no eps, no freezing, no
        # full-cube selects; this loop carries rnorm and is pure CG
        def body_fix(state, _):
            x, r, y, p, rnorm = state
            Ap = A(p)
            pAp = _band_vdot(p, Ap)
            alpha = jnp.where(pAp != 0,
                              rnorm / jnp.where(pAp == 0, 1.0, pAp),
                              0.0)
            x = x + alpha * p
            r = r + alpha * Ap
            y = M(r) if has_M else r
            rnorm_next = _band_vdot(r, y)
            beta = jnp.where(rnorm != 0,
                             rnorm_next / jnp.where(rnorm == 0, 1.0,
                                                    rnorm), 0.0)
            p = beta * p - y
            return (x, r, y, p, rnorm_next), None

        (x, _, _, _, _), _ = lax.scan(
            body_fix, (x0, r, y, p, rnorm0), None, length=maxit)
        _summary(name, jnp.asarray(maxit), jnp.zeros_like(rnorm0),
                 verbosity)
        return x

    # derive per-band scalars from the input so they inherit its
    # sharding/varyence (required when running inside shard_map)
    eps0 = jnp.ones_like(b[:, :1, :1]).astype(dt)
    active0 = jnp.ones_like(b[:, :1, :1], dtype=bool)

    def cond(state):
        x, r, y, p, rnorm, eps, active, k = state
        return jnp.any(active[:, 0, 0]) & (k < maxit)

    def body(state):
        x, r, y, p, rnorm, eps, active, k = state
        xp = x
        Ap = A(p)
        pAp = _band_vdot(p, Ap)
        alpha0 = jnp.where(pAp != 0, rnorm / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        # frozen bands take a zero step: x/r/y stay put without
        # full-cube selects
        actf = active.astype(alpha0.dtype)

        def step(alpha):
            x_ = xp + alpha * p
            r_ = r + alpha * Ap
            y_ = M(r_) if has_M else r_
            return x_, r_, y_, _band_vdot(r_, y_)

        alpha0 = alpha0 * actf
        xn, rn, yn, rnorm_next = step(alpha0)

        if backtrack:
            def bt_cond(bt):
                alpha, x_, r_, y_, rnn = bt
                return jnp.any(active & (rnn > rnorm))

            def bt_body(bt):
                alpha, x_, r_, y_, rnn = bt
                alpha = jnp.where(active & (rnn > rnorm),
                                  alpha * 0.75, alpha)
                x_, r_, y_, rnn = step(alpha)
                return alpha, x_, r_, y_, rnn

            _, xn, rn, yn, rnorm_next = lax.while_loop(
                bt_cond, bt_body, (alpha0, xn, rn, yn, rnorm_next))

        beta = jnp.where(rnorm != 0,
                         rnorm_next / jnp.where(rnorm == 0, 1.0, rnorm), 0.0)
        # frozen bands: p unchanged (beta -> 1, y-term masked out)
        beta = jnp.where(active, beta, 1.0)
        p_new = beta * p - actf * yn

        num = jnp.sum((xn - xp) ** 2, axis=(-2, -1), keepdims=True)
        den = 1e-12 + jnp.sum(xn**2, axis=(-2, -1), keepdims=True)
        eps_new = jnp.sqrt(num / den)
        eps = jnp.where(active, eps_new, eps)

        # freeze converged bands (eps <= tol after minit iterations)
        active_new = active & ((eps > tol) | (k + 1 < minit))
        rnorm_next = jnp.where(active, rnorm_next, rnorm)
        _progress(name, k, eps, report_freq, verbosity)
        return xn, rn, yn, p_new, rnorm_next, eps, active_new, k + 1

    state0 = (x0, r, y, p, rnorm0, eps0, active0,
              jnp.asarray(0, jnp.int32))
    x, _, _, _, _, eps, _, k = lax.while_loop(cond, body, state0)
    _summary(name, k, eps, verbosity)
    return x


def make_pcg_bands_fused(apply, M=None, tol=1e-5, maxit=500,
                         minit=100, backtrack=True, verbosity=0,
                         report_freq=10, name="pcg"):
    """Jit :func:`pcg_bands` around an operator of the form
    ``apply(x, consts)`` with the operator constants passed as runtime
    arguments: ``solve = make_pcg_bands_fused(hess.apply, ...)`` then
    ``x = solve(b, x0, hess.consts)`` (``make_psf_convolve`` exposes
    ``.apply``/``.consts``).

    The GB-scale transfer function enters the fused while_loop program
    as a jit argument: a closed-over array would be baked into the
    executable as a constant. One compiled program, zero per-iteration
    host work."""
    import jax

    @jax.jit
    def solve(b, x0, consts):
        return pcg_bands(lambda z: apply(z, consts), b, x0=x0, M=M,
                         tol=tol, maxit=maxit, minit=minit,
                         backtrack=backtrack, verbosity=verbosity,
                         report_freq=report_freq, name=name)

    return solve


def cg_dct(A, b, x, tol=1e-5, maxit=500):
    """CG over a dict-of-grids primal variable for multi-field imaging
    (reference: pfb/opt/pcg.py:139-239, cg_dct). ``A`` maps and returns
    pytrees matching ``b``/``x`` (dicts keyed on field then (t, b));
    inner products reduce over all leaves. No preconditioning or
    backtracking, like the reference.
    """
    import jax

    def tree_vdot(a, c):
        return sum(jnp.vdot(x_, y_).real for x_, y_ in zip(
            jax.tree.leaves(a), jax.tree.leaves(c)))

    def axpy(a, c, alpha):
        return jax.tree.map(lambda x_, y_: x_ + alpha * y_, a, c)

    r = jax.tree.map(lambda ax, bx: ax - bx, A(x), b)
    p = jax.tree.map(lambda rx: -rx, r)
    rnorm = tree_vdot(r, r)
    k = 0
    eps = rnorm
    while eps > tol and k < maxit:
        Ap = A(p)
        alpha = rnorm / tree_vdot(p, Ap)
        x = axpy(x, p, alpha)
        r = axpy(r, Ap, alpha)
        rnorm_next = tree_vdot(r, r)
        beta = rnorm_next / rnorm
        p = jax.tree.map(lambda p_, r_: beta * p_ - r_, p, r)
        rnorm = rnorm_next
        eps = rnorm
        k += 1
    return x, r


def pcg_psf(psfhat, b, x0, beam=None, lastsize=None, sigmainv=0.0,
            tol=1e-5, maxit=500, minit=100, backtrack=True,
            verbosity=0, report_freq=10):
    """PCG against the per-band PSF Hessian, used by the klean flux mop
    (reference: pfb/opt/pcg.py:310-360). sigmainv>0 adds Tikhonov
    regularisation and enables the diagonal preconditioner M(x)=x/sigmainv
    (reference: pcg.py:263-267)."""
    from pfb_tpu.ops.psf import hessian_psf_cube

    if lastsize is None:
        lastsize = psfhat.shape[-2]

    def A(x):
        return hessian_psf_cube(x, psfhat, beam=beam, lastsize=lastsize,
                                sigmainv=sigmainv)

    M = (lambda x: x / sigmainv) if sigmainv > 0 else None
    return pcg_bands(A, b, x0=x0, M=M, tol=tol, maxit=maxit, minit=minit,
                     backtrack=backtrack, verbosity=verbosity,
                     report_freq=report_freq)
