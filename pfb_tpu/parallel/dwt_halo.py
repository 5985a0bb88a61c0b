"""Space-sharded SARA dictionary with filter-length halo exchange.

Replaces the all_gather + replicated-transform Psi of
``parallel/dist.py`` (round-3 ``_psi_dot_space_local``): there every
space shard gathered the FULL band-row image and ran the complete DWT,
so per-device wavelet compute was constant in nspace and the comms were
O(image). Here both scale ~1/nspace (SURVEY.md section 5, the
"long-context analogue"; the reference has no spatial sharding at all —
its dual cubes live whole on each band actor,
pfb/opt/primal_dual.py:183-306).

Layouts (matching primal_dual_space_dist):
  image cube  P('band', 'space', None)   — x rows sharded
  dual cube   P('band', None, 'space', None) — packed coeff rows
              (the y-derived axis) sharded in chunks of qy

Design, per basis, per analysis level i (sizes all static):

1. *Pass 1* — the y-axis analysis convolutions run LOCALLY on the
   x-sharded approx rows (y is unsharded).
2. *Packed-aligned transpose* — the (rows, 2Cy) pass-1 output is
   left-padded by the level's packed row offset W_y and right-padded to
   ps*qy, then ONE all_to_all + local transpose lands each shard
   exactly the packed coefficient rows it owns. Pad rows are zero, so
   pass-2 outputs on them vanish identically — no realignment needed.
3. *Pass 2* — the x-axis convolutions are now local (each shard holds
   ALL x for its qy packed rows); the level block is masked into the
   shard's packed canvas with the reference's deeper-overwrites-
   shallower semantics (pfb/wavelets/wavelets.py:174-214).
4. *Approx recursion with halo exchange* — the next level's approx
   (lo_y then lo_x) stays x-sharded: the strided lo_x convolution needs
   exactly F-2 rows from the left neighbour (one ppermute — the
   filter-length halo). Because the zero-extension DWT grows by (F-2)/2
   coefficients per level, the rows beyond nx/2^i ("tail", bounded by
   F-1 rows) are computed from a gathered F-2-row strip and carried
   REPLICATED — a few rows, negligible.

Synthesis mirrors the chain exactly (two all_to_all transposes per
level, masks for block extraction and the approx-quadrant insert, no
halo convolutions needed since both synthesis convolutions run on
locally-complete axes).

Per-device comms per application ~ 2.3 * image/nspace (all_to_all)
vs image * (ps-1)/ps for the gather design; per-device flops
~ total/nspace + O(F * image-width) tail work.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pfb_tpu.ops.psi import PsiSpec
from pfb_tpu.ops.wavelets import (WaveletSpec, _down_conv_last,
                                  _up_conv_last, coeff_size)

AXIS = "space"


@dataclass(frozen=True)
class HaloLevel:
    Nx: int      # true input x size (global)
    Ny: int      # true input y size
    Cx: int      # x coeff count (== spec.sx[i])
    Cy: int      # y coeff count (== spec.sy[i])
    Wx: int      # packed col offset of this level's block
    Wy: int      # packed row offset of this level's block
    c_in: int    # main (sharded) input rows per shard = nx / (2^i ps)
    t_in: int    # replicated tail input rows = Nx - ps * c_in
    spx: int     # synthesis output x size
    spy: int     # synthesis output y size


@dataclass(frozen=True)
class HaloBasisPlan:
    wavelet: str
    spec: Optional[WaveletSpec]
    levels: Tuple[HaloLevel, ...]


@dataclass(frozen=True)
class HaloPsiPlan:
    psi: PsiSpec
    ps: int
    qy: int
    bases: Tuple[HaloBasisPlan, ...]


def make_halo_plan(psi: PsiSpec, ps: int, qy: int) -> HaloPsiPlan:
    """Static bookkeeping; raises ValueError where the halo design's
    shape preconditions fail (caller falls back to the gather path)."""
    nx = psi.nx
    L = psi.nlevel
    if nx % (ps * 2 ** L) != 0:
        raise ValueError(
            f"halo DWT needs nx={nx} divisible by ps*2^L={ps * 2**L}")
    plans = []
    for w, s in zip(psi.bases, psi.specs):
        if w == "self":
            plans.append(HaloBasisPlan(w, None, ()))
            continue
        F = s.F
        levels = []
        Nx, Ny = s.nx, s.ny
        for i in range(L):
            c_in = nx // (2 ** i * ps)
            t_in = Nx - ps * c_in
            if t_in < 0:
                raise ValueError(f"negative tail at level {i}")
            if i < L - 1 and c_in // 2 < F - 2:
                # halo/strips would span >1 neighbour
                raise ValueError(
                    f"halo DWT: local chunk {c_in//2} < F-2={F-2} "
                    f"at level {i+1}")
            Cx, Cy = s.sx[i], s.sy[i]
            assert Cx == coeff_size(Nx + Nx % 2, F) or \
                Cx == coeff_size(Nx, F), (Cx, Nx, F)
            Wx = s.ix[i][1] - 2 * Cx
            Wy = s.iy[i][1] - 2 * Cy
            if Wy + 2 * Cy > ps * qy:
                raise ValueError("packed rows exceed ps*qy")
            levels.append(HaloLevel(Nx, Ny, Cx, Cy, Wx, Wy, c_in,
                                    t_in, s.spx[i], s.spy[i]))
            Nx, Ny = Cx, Cy
        plans.append(HaloBasisPlan(w, s, tuple(levels)))
    return HaloPsiPlan(psi, ps, qy, tuple(plans))


def _pad_cols(a, left, total):
    """Zero-pad the last axis: ``left`` zeros then up to ``total``."""
    right = total - left - a.shape[-1]
    assert right >= 0, (a.shape, left, total)
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(left, right)])


def _a2a_to_rows(a, qy):
    """(nbl, rows_local, ps*qy) -> (nbl, qy, ps*rows_local): one
    all_to_all + local transpose; output rows are the GLOBAL padded
    column indices this shard owns ([r*qy, (r+1)*qy))."""
    g = lax.all_to_all(a, AXIS, split_axis=2, concat_axis=1,
                       tiled=True)
    return jnp.swapaxes(g, 1, 2)


def _a2a_to_cols(a, chunk):
    """(nbl, qy, ps*chunk) -> (nbl, chunk, ps*qy): inverse transpose —
    output rows are this shard's chunk of the (padded) column axis,
    output cols the full global row axis."""
    g = lax.all_to_all(a, AXIS, split_axis=2, concat_axis=1,
                       tiled=True)
    return jnp.swapaxes(g, 1, 2)


def _halo_down_conv(main, f):
    """Strided zero-extension analysis conv ALONG THE SHARDED axis
    (axis 1) of main (nbl, c, m): ppermute the last F-2 rows from the
    left neighbour (shard 0 receives zeros — the zero extension), then
    a VALID stride-2 conv gives this shard's c/2 outputs exactly."""
    ps = lax.axis_size(AXIS)
    F = len(f)
    halo = main[:, -(F - 2):, :] if F > 2 else main[:, :0, :]
    if F > 2:
        halo = lax.ppermute(halo, AXIS,
                            [(i, i + 1) for i in range(ps - 1)])
    xin = jnp.concatenate([halo, main], axis=1)
    # conv along axis 1: move to last
    xt = jnp.swapaxes(xin, 1, 2)  # (nbl, m, c+F-2)
    k = jnp.asarray(f[::-1], xt.dtype).reshape(1, 1, F)
    lead = xt.shape[:-1]
    out = lax.conv_general_dilated(
        xt.reshape(-1, 1, xt.shape[-1]), k, window_strides=(2,),
        padding="VALID", precision=lax.Precision.HIGHEST)
    out = out.reshape(*lead, -1)
    return jnp.swapaxes(out, 1, 2)  # (nbl, c/2, m)


def _tail_conv(main_lo, tail_lo, f, n_out, c):
    """The analysis outputs beyond the sharded range (global x-coeff
    rows >= ps*c/2) depend only on the last F-2 main rows + the
    replicated tail: gather the strip, conv, return (nbl, n_out, m)
    replicated."""
    if n_out == 0:
        return main_lo[:, :0, :]
    ps = lax.axis_size(AXIS)
    F = len(f)
    need = max(F - 2, 0)
    take = min(need, main_lo.shape[1]) if need else 0
    if need:
        strip = lax.all_gather(main_lo[:, -take:, :] if take
                               else main_lo[:, :0, :], AXIS)
        # (ps, nbl, take, m) -> last `need` global rows
        strip = jnp.moveaxis(strip, 0, 1).reshape(
            main_lo.shape[0], ps * take, -1)
        if ps * take < need:
            strip = jnp.pad(strip,
                            [(0, 0), (need - ps * take, 0), (0, 0)])
        else:
            strip = strip[:, -need:, :]
        xin = jnp.concatenate([strip, tail_lo], axis=1)
    else:
        xin = tail_lo
    # out[o''] = sum_j f[j] xin[2o'' + F-1-j]; pad right so the VALID
    # window exists for all n_out outputs
    have = xin.shape[1]
    want = 2 * (n_out - 1) + F - 1 + 1
    if want > have:
        xin = jnp.pad(xin, [(0, 0), (0, want - have), (0, 0)])
    xt = jnp.swapaxes(xin, 1, 2)
    k = jnp.asarray(f[::-1], xt.dtype).reshape(1, 1, F)
    lead = xt.shape[:-1]
    out = lax.conv_general_dilated(
        xt.reshape(-1, 1, xt.shape[-1]), k, window_strides=(2,),
        padding="VALID", precision=lax.Precision.HIGHEST)
    out = out.reshape(*lead, -1)[..., :n_out]
    return jnp.swapaxes(out, 1, 2)


def _grow(qy):
    r = lax.axis_index(AXIS)
    return r * qy + jnp.arange(qy)


def halo_psi_dot_local(xl, plan: HaloPsiPlan):
    """Shard-local analysis body (inside shard_map over AXIS):
    xl (nbl, nxl, ny) -> (nbl, nbasis, qy, Nxmax)."""
    psi, ps, qy = plan.psi, plan.ps, plan.qy
    nbl = xl.shape[0]
    dt = xl.dtype
    grow = _grow(qy)
    outs = []
    for bp in plan.bases:
        canvas = jnp.zeros((nbl, qy, psi.Nxmax), dt)
        if bp.wavelet == "self":
            # x.T: rows become y — one transpose all_to_all
            a = _pad_cols(xl, 0, ps * qy)
            gT = _a2a_to_rows(a, qy)             # (nbl, qy, nx)
            canvas = canvas.at[..., :psi.nx].set(gT)
            outs.append(canvas)
            continue
        s = bp.spec
        lo, hi = s.dec_lo, s.dec_hi
        main = xl
        tail = xl[:, :0, :]
        for li, lev in enumerate(bp.levels):
            m = main[..., :lev.Ny]
            tl = tail[..., :lev.Ny]
            mlo = _down_conv_last(m, lo)         # (nbl, c, Cy)
            mhi = _down_conv_last(m, hi)
            if lev.t_in:
                tlo = _down_conv_last(tl, lo)    # (nbl, t, Cy)
                thi = _down_conv_last(tl, hi)
            else:
                tlo = thi = jnp.zeros((tl.shape[0], 0, lev.Cy),
                                      tl.dtype)
            # pass 2 via packed-aligned transpose
            cat = jnp.concatenate([mlo, mhi], axis=-1)
            catp = _pad_cols(cat, lev.Wy, ps * qy)
            gT = _a2a_to_rows(catp, qy)          # (nbl, qy, ps*c)
            if lev.t_in:
                tcat = jnp.concatenate([tlo, thi], axis=-1)
                tcatp = _pad_cols(tcat, lev.Wy, ps * qy)
                tsl = lax.dynamic_slice_in_dim(
                    tcatp, lax.axis_index(AXIS) * qy, qy, axis=2)
                row_full = jnp.concatenate(
                    [gT, jnp.swapaxes(tsl, 1, 2)], axis=-1)
            else:
                row_full = gT
            row_full = row_full[..., :lev.Nx]
            xlo = _down_conv_last(row_full, lo)  # (nbl, qy, Cx)
            xhi = _down_conv_last(row_full, hi)
            blk = jnp.concatenate([xlo, xhi], axis=-1)
            rowmask = ((grow >= lev.Wy) &
                       (grow < lev.Wy + 2 * lev.Cy))[None, :, None]
            seg = canvas[..., lev.Wx:lev.Wx + 2 * lev.Cx]
            canvas = canvas.at[..., lev.Wx:lev.Wx + 2 * lev.Cx].set(
                jnp.where(rowmask, blk, seg))
            # next approx: lo_x of the lo_y outputs
            if li + 1 < len(bp.levels):
                nxt = bp.levels[li + 1]
                main = _halo_down_conv(mlo, lo)  # (nbl, c/2, Cy)
                tail = _tail_conv(mlo, tlo, lo, nxt.t_in, lev.c_in)
        outs.append(canvas)
    return jnp.stack(outs, axis=1)


def halo_psi_hdot_local(al, plan: HaloPsiPlan):
    """Shard-local synthesis body: al (nbl, nbasis, qy, Nxmax) ->
    (nbl, nxl, ny), summed over bases."""
    psi, ps, qy = plan.psi, plan.ps, plan.qy
    nbl = al.shape[0]
    nxl = psi.nx // ps
    dt = al.dtype
    grow = _grow(qy)
    out = jnp.zeros((nbl, nxl, psi.ny), dt)
    for bi, bp in enumerate(plan.bases):
        canvas = al[:, bi]
        if bp.wavelet == "self":
            a = _pad_cols(canvas[..., :psi.nx], 0, ps * nxl)
            h = _a2a_to_cols(a, nxl)             # (nbl, nxl, ps*qy)
            out = out + h[..., :psi.ny]
            continue
        img = None
        nlev = len(bp.levels)
        for li in range(nlev - 1, -1, -1):
            lev = bp.levels[li]
            blk = canvas[..., lev.Wx:lev.Wx + 2 * lev.Cx]
            rowmask = ((grow >= lev.Wy) &
                       (grow < lev.Wy + 2 * lev.Cy))[None, :, None]
            blk = jnp.where(rowmask, blk, 0.0)
            if img is not None:
                # deeper reconstruction replaces the approx quadrant
                a = _pad_cols(img[..., :lev.Cy], lev.Wy, ps * qy)
                apprT = _a2a_to_rows(a, qy)      # (nbl, qy, ps*u)
                apprT = apprT[..., :lev.Cx]
                amask = ((grow >= lev.Wy) &
                         (grow < lev.Wy + lev.Cy))[None, :, None]
                seg = blk[..., :lev.Cx]
                blk = blk.at[..., :lev.Cx].set(
                    jnp.where(amask, apprT, seg))
            rx = _up_conv_last(blk[..., :lev.Cx], bp.spec.rec_lo,
                               lev.spx) + \
                _up_conv_last(blk[..., lev.Cx:], bp.spec.rec_hi,
                              lev.spx)           # (nbl, qy, spx)
            u = lev.c_in                          # = nx/(2^i ps)
            # x container: ps*u >= spx needed only up to what the next
            # shallower level reads; pad to a multiple of ps
            upad = -(-lev.spx // ps)
            if li == 0:
                upad = nxl                        # spx[0] == nx exactly
            rxp = _pad_cols(rx, 0, ps * upad)
            h = _a2a_to_cols(rxp, upad)          # (nbl, upad, ps*qy)
            hs = h[..., lev.Wy:lev.Wy + 2 * lev.Cy]
            img = _up_conv_last(hs[..., :lev.Cy], bp.spec.rec_lo,
                                lev.spy) + \
                _up_conv_last(hs[..., lev.Cy:], bp.spec.rec_hi,
                              lev.spy)           # (nbl, upad, spy)
        out = out + img[:, :nxl, :psi.ny]
    return out
