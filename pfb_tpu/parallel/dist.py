"""Distributed (band-sharded) solver steps via shard_map.

These are the SPMD equivalents of the reference's dask.distributed
solvers (pfb/opt/pcg.py:363-420 pcg_dist, primal_dual.py:183-306
primal_dual_dist, power_method.py:52-127 power_method_dist): each mesh
shard owns a slice of the band axis and holds its bands' PSFHAT/data
resident; the only communication is

- psum of scalars (norms, Rayleigh quotients, eps) — the reference's
  coordinator scalar reduces,
- psum of the (nbasis, Nymax, Nxmax) band-sum of dual coefficients for
  the MFS prox ratio — the reference's get_ratio gather/broadcast
  (primal_dual.py:270-290), here one allreduce.

Everything else is band-local, preserving the reference's "big cubes
stay put, reductions travel" design (SURVEY.md section 3.5).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from jax import shard_map

from pfb_tpu.ops.psf import hessian_psf_cube


def _hessian_engine(*, lastsize=None, sigmainv=0.0):
    """Per-shard PSF-Hessian matvec for the distributed solvers.

    Returns ``(local, hspecs)``: ``local(x, hargs)`` applies the XLA
    rFFT convolve to the shard-local band block with ``hargs =
    (psfhat,)``, and ``hspecs`` the matching band-sharded in_specs.
    The per-shard cube is band-local, so the matvec needs no
    communication — the reference's fast-operator-on-each-actor design
    (pfb/workers/spotless.py:429-667, hessian.py:129-158).
    """
    def local(x, hargs):
        return hessian_psf_cube(x, hargs[0], lastsize=lastsize,
                                sigmainv=sigmainv)

    return local, (P("band", None, None),)


def hessian_psf_dist(mesh, lastsize=None, sigmainv=0.0):
    """Band-sharded PSF-Hessian matvec: purely local per shard.

    The returned function takes ``(x, psfhat)`` with PSFHAT sharded
    over 'band'."""
    local, hspecs = _hessian_engine(lastsize=lastsize, sigmainv=sigmainv)
    spec = P("band", None, None)
    fn = shard_map(local, mesh=mesh, in_specs=(spec, hspecs),
                   out_specs=spec)
    jfn = jax.jit(fn)

    def run(x, *hargs):
        return jfn(x, tuple(hargs))

    return run


def hessian_psf_space_dist(mesh, lastsize, sigmainv=0.0,
                           method="fft"):
    """Band- AND space-sharded PSF-Hessian matvec.

    method="fft" (default): distributed rFFT2 convolution. The y-axis
    transform runs on the locally-owned image rows, one all_to_all over
    the 'space' axis transposes the spectrum so the x-axis transform is
    local, the (column-sharded) PSFHAT multiply and inverse x-transform
    follow, and a second all_to_all restores row sharding for the
    inverse y-transform. Per-device communication is O(cube / nshards)
    per matvec — the scalable replacement for the all_gather variant
    (SURVEY.md section 5, "long-context analogue"; the PSF kernel has
    full image support at psf_oversize=2 so a halo exchange would
    degenerate to all_gather, hence the distributed transform).

    method="allgather": each shard gathers the full rows and convolves
    locally — O(cube) received per device, kept for small images.

    Call :func:`prep_psfhat_space` once to lay PSFHAT out for the fft
    method (zero-padded to a column count divisible by the space axis,
    sharded over its spectral columns).
    """
    if method == "allgather":
        spec = P("band", "space", None)
        pspec = P("band", None, None)

        def local_ag(x, psfhat):
            nxl = x.shape[1]
            x_full = lax.all_gather(x, "space", axis=1, tiled=True)
            out = hessian_psf_cube(x_full, psfhat, lastsize=lastsize,
                                   sigmainv=sigmainv)
            rank = lax.axis_index("space")
            return lax.dynamic_slice_in_dim(out, rank * nxl, nxl,
                                            axis=1)

        fn = shard_map(local_ag, mesh=mesh, in_specs=(spec, pspec),
                       out_specs=spec)
        return jax.jit(fn)

    spec = P("band", "space", None)
    pspec = P("band", None, "space")

    def local(x, psfhat_p):
        return _space_fft_conv_local(x, psfhat_p, lastsize,
                                     sigmainv=sigmainv)

    fn = shard_map(local, mesh=mesh, in_specs=(spec, pspec),
                   out_specs=spec)
    return jax.jit(fn)


def _space_fft_conv_local(x, psfhat_p, lastsize, sigmainv=0.0,
                          nsplit=None):
    """Shard-local body of the distributed-rFFT2 PSF convolve (see
    :func:`hessian_psf_space_dist`). Runs inside a shard_map over
    ('band', 'space'); x: (nbl, nxl, ny) locally-owned image rows,
    psfhat_p: (nbl, nxp, nyw_l) locally-owned spectral columns from
    :func:`prep_psfhat_space`.

    ``nsplit`` pipelines the local band block through the collective
    boundaries in chunks (default: 2 when more than one band is
    local): chunk i+1's transforms are independent of chunk i's
    all_to_all, so XLA's latency-hiding scheduler can run the
    transfers under FFT compute instead of the strict
    a2a -> compute -> a2a serialisation (BASELINE.json north star:
    "collectives overlapped with FFT compute"; degenerate single-chunk
    and single-chip paths are unchanged)."""
    nbl = x.shape[0]
    if nsplit is None:
        nsplit = 2 if nbl % 2 == 0 and nbl > 1 else 1
    if nsplit > 1:
        parts = [
            _space_fft_conv_local(x[i::nsplit],
                                  psfhat_p[i::nsplit], lastsize,
                                  sigmainv=sigmainv, nsplit=1)
            for i in range(nsplit)]
        out = jnp.stack(parts, axis=1).reshape(x.shape)
        return out
    nyp = lastsize
    nyw = nyp // 2 + 1
    nxl, ny = x.shape[-2:]
    nxp, nyw_l = psfhat_p.shape[-2:]
    ps = lax.axis_size("space")
    nx = nxl * ps
    # forward y transform on owned rows
    xp = jnp.pad(x, [(0, 0), (0, 0), (0, nyp - ny)])
    xf = jnp.fft.rfft(xp, axis=-1)                # (nbl, nxl, nyw)
    xf = jnp.pad(xf, [(0, 0), (0, 0), (0, nyw_l * ps - nyw)])
    # transpose: gather all rows, keep 1/ps of the columns
    xf = lax.all_to_all(xf, "space", split_axis=2, concat_axis=1,
                        tiled=True)               # (nbl, nx, nyw_l)
    # x transform is now local; pad rows to the PSF size
    xf = jnp.pad(xf, [(0, 0), (0, nxp - nx), (0, 0)])
    xf = jnp.fft.fft(xf, axis=-2)
    xf = xf * psfhat_p
    xf = jnp.fft.ifft(xf, axis=-2)[:, :nx]
    # transpose back: keep own rows, gather all columns
    xf = lax.all_to_all(xf, "space", split_axis=1, concat_axis=2,
                        tiled=True)               # (nbl, nxl, nyw_l*ps)
    out = jnp.fft.irfft(xf[..., :nyw], n=nyp, axis=-1)[..., :ny]
    if sigmainv:
        out = out + x * sigmainv
    return out.real.astype(x.dtype)


def prep_psfhat_space(psfhat, nspace):
    """Lay PSFHAT out for the distributed-FFT convolve: zero-pad the
    spectral column axis to a multiple of the 'space' shard count (the
    all_to_all needs equal splits; rfft gives nyp//2+1 columns which
    never divides evenly). Shard the result P('band', None, 'space')."""
    nyw = psfhat.shape[-1]
    nyw_p = nspace * (-(-nyw // nspace))
    return jnp.pad(psfhat, [(0, 0)] * (psfhat.ndim - 1)
                   + [(0, nyw_p - nyw)])


def power_method_dist(mesh, lastsize=None, tol=1e-5, maxit=200,
                      sigmainv=0.0):
    """Distributed power method: local matvecs + psum'd norms
    (reference power_method_dist, opt/power_method.py:52-127)."""
    hess, hspecs = _hessian_engine(lastsize=lastsize, sigmainv=sigmainv)
    spec = P("band", None, None)

    def body_fn(b0, hargs):
        def gnorm_sq(v):
            return lax.psum(jnp.sum(v * v), "band")

        def gvdot(a, b):
            return lax.psum(jnp.sum(a * b), "band")

        b = b0 / jnp.sqrt(gnorm_sq(b0))
        one = jnp.asarray(1.0, b0.dtype)

        def cond(state):
            b, beta, eps, k = state
            return (eps > tol) & (k < maxit)

        def body(state):
            bp, beta, eps, k = state
            bnew = hess(bp, hargs)
            betap = beta
            beta = gvdot(bp, bnew) / gvdot(bp, bp)
            bnew = bnew / jnp.sqrt(gnorm_sq(bnew))
            eps = jnp.abs(beta - betap) / betap
            return bnew, beta, eps, k + 1

        b, beta, eps, k = lax.while_loop(
            cond, body, (b, one, one, jnp.asarray(0, jnp.int32)))
        return beta[None], b

    fn = shard_map(body_fn, mesh=mesh, in_specs=(spec, hspecs),
                   out_specs=(P(None), spec))
    jfn = jax.jit(fn)

    def run(b0, *hargs):
        beta, b = jfn(b0, tuple(hargs))
        return beta[0], b

    return run


def pcg_dist(mesh, lastsize=None, sigmainv=0.0, tol=1e-5, maxit=500,
             minit=10):
    """Band-sharded PCG: per-band systems are independent, so each
    shard runs the batched per-band PCG on its local bands with no
    communication (reference pcg_dist, opt/pcg.py:363-420)."""
    from pfb_tpu.opt.pcg import pcg_bands

    hess, hspecs = _hessian_engine(lastsize=lastsize, sigmainv=sigmainv)
    spec = P("band", None, None)

    def local(b, x0, hargs):
        def A(x):
            return hess(x, hargs)

        M = (lambda x: x / sigmainv) if sigmainv > 0 else None
        return pcg_bands(A, b, x0=x0, M=M, tol=tol, maxit=maxit,
                         minit=minit)

    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec, hspecs),
                   out_specs=spec)
    jfn = jax.jit(fn)

    def run(b, x0, *hargs):
        return jfn(b, x0, tuple(hargs))

    return run


def _dual_update_dist(vp, v, lam, sigma, weight):
    """MFS dual update with the band sum psum'd across the band shards
    — the one true communication point of the distributed primal-dual
    (reference get_ratio, primal_dual.py:187-199)."""
    vtilde = vp + sigma * v
    local_sum = jnp.sum(vtilde, axis=0)
    global_sum = lax.psum(local_sum, "band")
    vsum = jnp.abs(global_sum) / sigma
    soft = jnp.maximum(vsum - lam * weight / sigma, 0.0)
    scale = jnp.where(vsum != 0,
                      1.0 - soft / jnp.where(vsum == 0, 1.0, vsum), 1.0)
    return vtilde * scale[None]


def primal_dual_dist(mesh, psi, lastsize=None, nu=None, tol=1e-5,
                     maxit=500, positivity=1, gamma=1.0, rmsfactor=1.0,
                     alpha=4.0, maxreweight=50):
    """Band-sharded primal-dual backward step with the single-device
    solver's reweight-on-converge restart (opt/primal_dual.py:86-93):
    when the relative change drops below tol and reweighting is enabled,
    the l1 weights are refreshed from the psum'd MFS coefficients and
    iteration continues.

    Returns a jitted function
        f(x, v, data, hargs, l1weight, lam, L, rms_comps, do_reweight)
            -> (x, v, l1weight, niters)
    with x, data (nband, nx, ny) and v (nband, nbasis, Nymax, Nxmax)
    sharded over 'band'; ``hargs`` the (psfhat,) operand tuple (a bare
    psfhat array is accepted);
    l1weight and rms_comps (nbasis, Nymax, Nxmax) replicated; lam, L
    scalars; do_reweight a traced bool so one compiled program serves
    both phases of the major cycle.
    """
    from pfb_tpu.ops.psi import psi_dot, psi_hdot

    hess, hspecs = _hessian_engine(lastsize=lastsize)
    if nu is None:
        nu = psi.nbasis
    cube = P("band", None, None)
    coeff = P("band", None, None, None)
    wspec = P(None, None, None)

    def local(x, v, data, hargs, l1weight, lam, L, rms_comps,
              do_reweight):
        sigma = L / (2.0 * gamma) / nu
        tau = 0.9 / (L / (2.0 * gamma) + sigma * nu**2)

        def grad(xl):
            return hess(xl, hargs) - data

        def gnorm_sq(a):
            return lax.psum(jnp.sum(a * a), "band")

        def reweight(xl):
            # l1reweight_func with the band sum psum'd over the shards
            # (reference utils/misc.py:1070-1080)
            mfs = lax.psum(jnp.sum(psi_dot(xl, psi), axis=0), "band")
            mcomps = jnp.abs(mfs)
            return (1 + rmsfactor) / \
                (1 + mcomps**alpha / rms_comps**alpha)

        def cond(state):
            xp, vp, w, nrw, eps, done, k = state
            return (~done) & (k < maxit)

        def body(state):
            xp, vp, w, nrw, eps, done, k = state
            vnew = _dual_update_dist(vp, psi_dot(xp, psi), lam, sigma,
                                     w)
            xout = psi_hdot(2.0 * vnew - vp, psi) + grad(xp)
            xnew = _apply_positivity_dist(xp - tau * xout, positivity)
            num = gnorm_sq(xnew - xp)
            den = 1e-12 + gnorm_sq(xnew)
            eps = jnp.sqrt(num / den)
            converged = eps < tol
            do_rw = converged & do_reweight & (nrw < maxreweight)
            w = lax.cond(do_rw, lambda: reweight(xnew), lambda: w)
            nrw = nrw + do_rw.astype(nrw.dtype)
            done = converged & ~do_rw
            return xnew, vnew, w, nrw, eps, done, k + 1

        dt = jnp.result_type(x.dtype, jnp.float32)
        state0 = (x, v, l1weight, jnp.asarray(0, jnp.int32),
                  jnp.asarray(1.0, dt), jnp.asarray(False),
                  jnp.asarray(0, jnp.int32))
        xf, vf, wf, nrw, eps, done, k = lax.while_loop(cond, body,
                                                       state0)
        return xf, vf, wf, k[None]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(cube, coeff, cube, hspecs, wspec, P(),
                             P(), wspec, P()),
                   out_specs=(cube, coeff, wspec, P(None)))
    jfn = jax.jit(fn)

    def run(x, v, data, hargs, l1weight, lam, L, rms_comps=None,
            do_reweight=False):
        if rms_comps is None:
            rms_comps = jnp.ones_like(l1weight)
        if not isinstance(hargs, tuple):
            hargs = (hargs,)
        xf, vf, wf, k = jfn(x, v, data, hargs, l1weight, lam, L,
                            rms_comps, jnp.asarray(do_reweight))
        return xf, vf, wf, k[0]

    return run


def _apply_positivity_dist(x, positivity):
    """Distributed twin of opt.primal_dual.apply_positivity: mode 2
    ("zero every pixel column where ANY band is <= 0", reference
    primal_dual.py:57-61) needs the any-band mask reduced across the
    'band' mesh axis — a shard-local jnp.any only sees local bands and
    silently diverges from the single-device solver at >1 band shard."""
    if positivity == 1:
        return jnp.maximum(x, 0.0)
    if positivity == 2:
        msk = jnp.any(x <= 0.0, axis=0, keepdims=True)
        msk = lax.psum(msk.astype(jnp.int32), "band") > 0
        return jnp.where(msk, 0.0, x)
    return x


def _psi_dot_space_local(xl, psi, qy):
    """Space-sharded SARA analysis, shard-local body: gather the full
    band-local image rows over 'space', run the (compact, cheap)
    wavelet transform, and keep only THIS shard's slice of packed
    coefficient rows. The dual cube — nbasis x the image, the object
    that outgrows device memory first — stays sharded; only the image
    (the small operand) travels. xl: (nbl, nxl, ny) ->
    (nbl, nbasis, qy, Nxmax) with qy = ceil(Nymax / nspace)."""
    from pfb_tpu.ops.psi import psi_dot

    x_full = lax.all_gather(xl, "space", axis=1, tiled=True)
    a = psi_dot(x_full, psi)          # (nbl, nbasis, Nymax, Nxmax)
    ps = lax.axis_size("space")
    a = jnp.pad(a, [(0, 0), (0, 0), (0, qy * ps - psi.Nymax), (0, 0)])
    r = lax.axis_index("space")
    return lax.dynamic_slice_in_dim(a, r * qy, qy, axis=2)


def _psi_hdot_space_local(al, psi, qy):
    """Space-sharded SARA synthesis, shard-local body: zero-pad the
    local packed-coefficient row slice back to the full layout,
    reconstruct, and psum_scatter the (linear) reconstruction so each
    shard receives exactly its image rows, summed over all coefficient
    shards. Exact because idwt2d is linear in the packed array (the
    overwritten approx quadrants are ignored identically for every
    slice). al: (nbl, nbasis, qy, Nxmax) -> (nbl, nxl, ny)."""
    from pfb_tpu.ops.psi import psi_hdot

    nbl, nbasis = al.shape[:2]
    ps = lax.axis_size("space")
    r = lax.axis_index("space")
    full = jnp.zeros((nbl, nbasis, qy * ps, al.shape[-1]), al.dtype)
    full = lax.dynamic_update_slice_in_dim(full, al, r * qy, axis=2)
    img = psi_hdot(full[:, :, :psi.Nymax, :], psi)   # (nbl, nx, ny)
    return lax.psum_scatter(img, "space", scatter_dimension=1,
                            tiled=True)


def primal_dual_space_dist(mesh, psi, lastsize, nu=None, tol=1e-5,
                           maxit=500, positivity=1, gamma=1.0,
                           rmsfactor=1.0, alpha=4.0, maxreweight=50,
                           psi_method="auto"):
    """Band- AND space-sharded primal-dual backward step: the image
    cube is sharded P('band','space',None), the dual/coefficient cube
    P('band',None,'space',None) over its packed rows, so per-device
    memory is O(nbasis*cube / (nband_shards*nspace)) — the PD analogue
    of :func:`hessian_psf_space_dist` (SURVEY.md section 5,
    "long-context analogue"; the reference has no spatial sharding at
    all, its dual cubes live whole on each band actor,
    pfb/opt/primal_dual.py:183-306).

    psi_method selects the space-sharded dictionary:
    - "halo" (parallel/dwt_halo.py): filter-length halo exchange +
      packed-aligned all_to_all transposes; wavelet compute AND comms
      scale ~1/nspace.
    - "gather": all_gather the band-local image rows and replicate the
      transform per shard (the round-3 design; O(image) comms,
      replicated compute).
    - "auto" (default): halo where its shape preconditions hold
      (nx divisible by nspace*2^nlevel, per-shard chunks >= F-2),
      else gather.

    The gradient runs the distributed-rFFT2 convolve (call
    :func:`prep_psfhat_space` on PSFHAT first; ``lastsize`` is the
    PSF's last axis). Returns a function
        f(x, v, data, psfhat_p, l1weight, lam, L, rms_comps,
          do_reweight) -> (x, v, l1weight, niters)
    accepting UNPADDED v/l1weight/rms_comps (padding of the packed
    row axis to the space multiple is handled here).
    """
    if nu is None:
        nu = psi.nbasis
    ps = mesh.shape["space"]
    if psi.nx % ps != 0:
        raise ValueError(
            f"image rows nx={psi.nx} not divisible by the mesh space "
            f"axis {ps} (required by the all_to_all/psum_scatter "
            f"transposes); pick a space axis that divides nx")
    qy = -(-psi.Nymax // ps)
    nyq = qy * ps

    halo_plan = None
    if psi_method in ("auto", "halo"):
        from pfb_tpu.parallel.dwt_halo import make_halo_plan
        try:
            halo_plan = make_halo_plan(psi, ps, qy)
        except ValueError:
            if psi_method == "halo":
                raise

    if halo_plan is not None:
        from pfb_tpu.parallel.dwt_halo import (halo_psi_dot_local,
                                               halo_psi_hdot_local)

        def psi_dot_l(xl):
            return halo_psi_dot_local(xl, halo_plan)

        def psi_hdot_l(al):
            return halo_psi_hdot_local(al, halo_plan)
    else:
        def psi_dot_l(xl):
            return _psi_dot_space_local(xl, psi, qy)

        def psi_hdot_l(al):
            return _psi_hdot_space_local(al, psi, qy)

    cube = P("band", "space", None)
    coeff = P("band", None, "space", None)
    wspec = P(None, "space", None)
    hspec = P("band", None, "space")

    def local(x, v, data, psfhat_p, l1weight, lam, L, rms_comps,
              do_reweight):
        sigma = L / (2.0 * gamma) / nu
        tau = 0.9 / (L / (2.0 * gamma) + sigma * nu**2)

        def grad(xl):
            return _space_fft_conv_local(xl, psfhat_p, lastsize) - data

        def gnorm_sq(a):
            return lax.psum(jnp.sum(a * a), ("band", "space"))

        def reweight(xl):
            # MFS band sum over 'band' shards; each space shard only
            # needs ITS coefficient rows (elementwise formula)
            a = psi_dot_l(xl)
            mfs = lax.psum(jnp.sum(a, axis=0), "band")
            mcomps = jnp.abs(mfs)
            return (1 + rmsfactor) / \
                (1 + mcomps**alpha / rms_comps**alpha)

        def cond(state):
            xp, vp, w, nrw, eps, done, k = state
            return (~done) & (k < maxit)

        def body(state):
            xp, vp, w, nrw, eps, done, k = state
            vnew = _dual_update_dist(
                vp, psi_dot_l(xp), lam, sigma, w)
            xout = psi_hdot_l(2.0 * vnew - vp) + grad(xp)
            xnew = _apply_positivity_dist(xp - tau * xout, positivity)
            num = gnorm_sq(xnew - xp)
            den = 1e-12 + gnorm_sq(xnew)
            eps = jnp.sqrt(num / den)
            converged = eps < tol
            do_rw = converged & do_reweight & (nrw < maxreweight)
            w = lax.cond(do_rw, lambda: reweight(xnew), lambda: w)
            nrw = nrw + do_rw.astype(nrw.dtype)
            done = converged & ~do_rw
            return xnew, vnew, w, nrw, eps, done, k + 1

        dt = jnp.result_type(x.dtype, jnp.float32)
        state0 = (x, v, l1weight, jnp.asarray(0, jnp.int32),
                  jnp.asarray(1.0, dt), jnp.asarray(False),
                  jnp.asarray(0, jnp.int32))
        xf, vf, wf, nrw, eps, done, k = lax.while_loop(cond, body,
                                                       state0)
        return xf, vf, wf, k[None]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(cube, coeff, cube, hspec, wspec, P(), P(),
                             wspec, P()),
                   out_specs=(cube, coeff, wspec, P(None)))
    jfn = jax.jit(fn)

    def padq(a, value=0.0):
        return jnp.pad(a, [(0, 0)] * (a.ndim - 2)
                       + [(0, nyq - psi.Nymax), (0, 0)],
                       constant_values=value)

    def run(x, v, data, psfhat_p, l1weight, lam, L, rms_comps=None,
            do_reweight=False):
        if rms_comps is None:
            rms_comps = jnp.ones_like(l1weight)
        # rms_comps pads with ones: 0**alpha/0**alpha in the reweight
        # formula would be nan (harmless but unsightly) on padded rows
        xf, vf, wf, k = jfn(x, padq(v), data, psfhat_p, padq(l1weight),
                            lam, L, padq(rms_comps, 1.0),
                            jnp.asarray(do_reweight))
        return (xf, vf[:, :, :psi.Nymax], wf[:, :psi.Nymax], k[0])

    return run


def coeff_rms_dist(mesh, psi, pix_per_beam):
    """Coefficient-space rms of a weighted residual cube with the MFS
    band-sum psum'd across shards — the distributed twin of the
    coeff_rms closure in workers/spotless.py (reference
    spotless.py:213-223). `bandw` carries the per-band wsum/wsums
    weighting (zero for empty bands), sharded with the cube."""
    from pfb_tpu.ops.psi import psi_dot

    cube = P("band", None, None)

    def local(resid, bandw):
        tmp = resid * bandw[:, None, None] / pix_per_beam
        coeffs = psi_dot(tmp, psi)
        mfs = lax.psum(jnp.sum(coeffs, axis=0), "band")
        return jnp.std(mfs, axis=(-1, -2))

    fn = shard_map(local, mesh=mesh, in_specs=(cube, P("band")),
                   out_specs=P(None))
    return jax.jit(fn)


def make_hessian_dds_dist(mesh, dds, nband, wsum, nx, ny,
                          sigmainv=0.0, use_beam=True,
                          mask_image=None, backend="dft",
                          epsilon=1e-7, do_wgridding=True):
    """Band-sharded exact vis-space Hessian over datasets: the
    distributed twin of ops.gridder.make_hessian_dds (reference
    hessian.py:11-59 reduced per band on its own worker,
    spotless.py:429-667 design intent). The matvec takes and returns a
    (nband, nx, ny) cube sharded P('band', None, None) and runs R.H W R
    per band with NO communication — big cubes stay put.

    'wgrid': every dataset's gridder is planned once with its
    arrays committed to the device that owns the dataset's band; the
    matvec applies each band's planned operators on that device's
    shard of the cube (dispatch is asynchronous, so the devices run
    concurrently) and reassembles the sharded result. 'dft': the exact
    direct transform over stacked datasets under shard_map (the oracle
    — O(Npix·Nvis), test scale only).
    """
    if backend != "dft":
        return _make_hessian_dds_dist_planned(
            mesh, dds, nband, wsum, nx, ny, sigmainv=sigmainv,
            use_beam=use_beam, mask_image=mask_image, backend=backend,
            epsilon=epsilon, do_wgridding=do_wgridding)
    from pfb_tpu.ops.gridder import (_hessian_stacked_local, stack_dds)

    st = stack_dds(dds, nband, use_beam=use_beam,
                   mask_image=mask_image)
    has_beam = st["beam"] is not None
    kern = partial(_hessian_stacked_local, cell=st["cell"],
                   x0=st["x0"], y0=st["y0"], nx=nx, ny=ny)

    cube = P("band", None, None)
    dspec4 = P("band", None, None, None)

    def local(x, *a):
        conv = kern(x, *a) if has_beam else kern(x, *a, None)
        out = conv / wsum
        if sigmainv:
            out = out + x * sigmainv**2
        return out

    in_specs = (cube, dspec4, P("band", None, None), dspec4, dspec4)
    if has_beam:
        in_specs = in_specs + (dspec4,)
    fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                   out_specs=cube)

    sh4 = jax.NamedSharding(mesh, dspec4)
    sh3 = jax.NamedSharding(mesh, P("band", None, None))
    args = [jax.device_put(jnp.asarray(st["uvw"]), sh4),
            jax.device_put(jnp.asarray(st["freq"]), sh3),
            jax.device_put(jnp.asarray(st["wgt"]), sh4),
            jax.device_put(jnp.asarray(st["mask"]), sh4)]
    if has_beam:
        args.append(jax.device_put(jnp.asarray(st["beam"]), sh4))

    jfn = jax.jit(fn)

    def matvec(x):
        return jfn(x, *args)

    return matvec


def band_devices(mesh, nband):
    """The device holding each band of a P('band', None, None) cube
    (one device per band: the first along the mesh's other axes)."""
    sharding = jax.NamedSharding(mesh, P("band", None, None))
    idx = sharding.devices_indices_map((nband, 1, 1))
    out = [None] * nband
    for dev, ix in idx.items():
        for b in range(nband)[ix[0]]:
            if out[b] is None or dev.id < out[b].id:
                out[b] = dev
    return out


def _make_hessian_dds_dist_planned(mesh, dds, nband, wsum, nx, ny,
                                   sigmainv=0.0, use_beam=True,
                                   mask_image=None, backend="wgrid",
                                   epsilon=1e-7, do_wgridding=True):
    """Planned-gridder backend of :func:`make_hessian_dds_dist` (see
    there)."""
    from pfb_tpu.ops.gridder import hessian_planned, plan_hessian_datasets

    devs = band_devices(mesh, nband)
    ops = plan_hessian_datasets(dds, nx, ny, backend, epsilon,
                                do_wgridding, use_beam, mask_image,
                                devices=devs)
    sharding = jax.NamedSharding(mesh, P("band", None, None))
    wsum = float(wsum)

    def matvec(x):
        if not x.sharding.is_equivalent_to(sharding, x.ndim):
            x = jax.device_put(x, sharding)  # e.g. a space-sharded cube
        shard_of = {sh.device: sh for sh in x.addressable_shards}
        conv = {}
        for b, g, wgt, msk, beam in ops:
            sh = shard_of[devs[b]]
            b0 = sh.index[0].start or 0
            c = hessian_planned(sh.data[b - b0], g, wgt, msk, beam)
            conv[b] = c if b not in conv else conv[b] + c
        blocks = {}
        pieces = []
        for sh in x.addressable_shards:
            b0 = sh.index[0].start or 0
            if b0 not in blocks:
                home = shard_of[devs[b0]].data
                blk = jnp.stack([conv[b] if b in conv
                                 else jnp.zeros_like(home[0])
                                 for b in range(b0, b0 + home.shape[0])])
                out = blk / wsum
                if sigmainv:
                    out = out + home * sigmainv**2
                blocks[b0] = out
            # space-axis replicas of a band block get a device copy
            pieces.append(jax.device_put(blocks[b0], sh.device))
        return jax.make_array_from_single_device_arrays(
            x.shape, sharding, pieces)

    return matvec
