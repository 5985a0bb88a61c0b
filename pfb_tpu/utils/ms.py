"""Minimal measurement-set container.

The reference reads CASA Measurement Sets through dask-ms/casacore
(pfb/workers/init.py:236). Neither exists here, so observations live in
a single .npz with the same column names an MS main table would have:

    DATA (nrow, nchan, ncorr) complex
    UVW (nrow, 3), TIME (nrow,), ANTENNA1/2 (nrow,)
    FLAG (nrow, nchan, ncorr) bool, WEIGHT_SPECTRUM (nrow, nchan, ncorr)
    FREQ (nchan,), RA, DEC (phase centre, rad), POLTYPE ('linear'|'circular')

plus optional MODEL_DATA / CORRECTED_DATA columns. Real-MS ingestion can
be added behind the same interface when casacore is available.
"""

from pathlib import Path

import numpy as np


def write_ms(path, **columns):
    np.savez(path, **columns)


def read_ms(path):
    """Read an observation into the column-dict layout. ``.npz`` files
    load directly; a directory path is treated as a CASA Measurement
    Set and read through python-casacore when available (the
    reference's dask-ms path, workers/init.py:236)."""
    path = str(path)
    from pathlib import Path as _P
    if _P(path).is_dir():
        return read_ms_casa(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def read_ms_casa(path):
    """CASA Measurement Set -> column dict (whole table, for small
    sets; production ingestion streams row slabs through
    :class:`CasaMSSource` instead). Requires python-casacore
    (import-gated: it is an optional dependency)."""
    src = CasaMSSource(path)
    out = dict(src.index())
    out.update(src.read_rows(np.arange(src.nrow), src.data_columns()))
    return out


def _casa_table():
    try:
        from casacore.tables import table
    except ImportError as e:
        raise ImportError(
            "Reading a CASA Measurement Set needs python-casacore "
            "(pip install python-casacore); alternatively convert to "
            "the npz container layout documented in pfb_tpu.utils.ms."
        ) from e
    return table


class CasaMSSource:
    """Slab-streaming CASA MS reader: the small per-row INDEX columns
    (TIME/FIELD_ID/DATA_DESC_ID/SCAN_NUMBER/ANTENNA1/2) and the
    subtables load once; the big per-row columns (DATA/FLAG/WEIGHT/
    UVW/...) are read per row-slab with ``table.getcol(startrow,
    nrow)`` over maximal CONSECUTIVE runs of the requested rows —
    bounded memory for observations larger than RAM (the reference
    streams chunked reads through dask-ms,
    /root/reference/pfb/utils/misc.py:250-370, workers/init.py:236)."""

    INDEX_COLS = ("TIME", "ANTENNA1", "ANTENNA2", "FIELD_ID",
                  "DATA_DESC_ID", "SCAN_NUMBER")

    def __init__(self, path, max_slab_rows=100_000):
        self._table = _casa_table()
        self.path = str(path)
        self.max_slab_rows = int(max_slab_rows)
        with self._table(self.path, ack=False) as t:
            self.nrow = t.nrows()
            self._cols = set(t.colnames())

    def data_columns(self):
        cols = [c for c in ("DATA", "MODEL_DATA", "CORRECTED_DATA",
                            "UVW", "FLAG", "WEIGHT_SPECTRUM", "WEIGHT",
                            "SIGMA", "SIGMA_SPECTRUM")
                if c in self._cols]
        return tuple(cols)

    def index(self):
        """Small columns + subtable metadata, loaded once."""
        out = {}
        with self._table(self.path, ack=False) as t:
            for col in self.INDEX_COLS:
                if col in self._cols:
                    out[col] = t.getcol(col)
        # DATA_DESCRIPTION maps DDID -> (SPW row, POLARIZATION row);
        # DDIDs are NOT SPW indices in general
        with self._table(f"{self.path}::DATA_DESCRIPTION",
                         ack=False) as t:
            spw_of_dd = t.getcol("SPECTRAL_WINDOW_ID")
            pol_of_dd = t.getcol("POLARIZATION_ID")
        with self._table(f"{self.path}::SPECTRAL_WINDOW",
                         ack=False) as t:
            freq = t.getcol("CHAN_FREQ")  # (nspw, nchan)
            by_dd = freq[spw_of_dd]       # indexable by DDID
            out["FREQ"] = by_dd[0] if by_dd.shape[0] == 1 else by_dd
        with self._table(f"{self.path}::FIELD", ack=False) as t:
            pc = t.getcol("PHASE_DIR")[:, 0, :]  # (nfield, 2)
            out["FIELD_RA"] = pc[:, 0]
            out["FIELD_DEC"] = pc[:, 1]
            out["RA"] = np.array(pc[0, 0])
            out["DEC"] = np.array(pc[0, 1])
        with self._table(f"{self.path}::POLARIZATION", ack=False) as t:
            corr = t.getcol("CORR_TYPE")[int(pol_of_dd[0])]
            # CASA stokes enums: 5-8 = RR,RL,LR,LL; 9-12 = XX,XY,YX,YY
            out["POLTYPE"] = np.array(
                "circular" if corr[0] in (5, 6, 7, 8) else "linear")
        return out

    def read_rows(self, rows, columns):
        """Read ``columns`` for the given row indices as one dict of
        arrays, slab by slab: consecutive-run segments (capped at
        max_slab_rows) become ``getcol(startrow, nrow)`` calls, so a
        time-sorted MS streams sequentially and a scattered selection
        degrades gracefully."""
        rows = np.asarray(rows, np.int64)
        out = {}
        # maximal consecutive runs
        runs = []
        if rows.size:
            brk = np.where(np.diff(rows) != 1)[0] + 1
            for seg in np.split(rows, brk):
                s = 0
                while s < seg.size:
                    e = min(s + self.max_slab_rows, seg.size)
                    runs.append((int(seg[s]), int(e - s)))
                    s = e
        with self._table(self.path, ack=False) as t:
            for col in columns:
                if col not in self._cols:
                    continue
                parts = [t.getcol(col, startrow=r0, nrow=nr)
                         for r0, nr in runs]
                if parts:
                    out[col] = np.concatenate(parts, axis=0)
        if "WEIGHT_SPECTRUM" in columns and \
                "WEIGHT_SPECTRUM" not in out and "WEIGHT" in out and \
                "DATA" in out:
            w = out["WEIGHT"]  # (nrow, ncorr)
            out["WEIGHT_SPECTRUM"] = np.repeat(
                w[:, None, :], out["DATA"].shape[1], axis=1)
        return out


class DictMSSource:
    """In-memory source over a column dict (the npz container /
    programmatic path) with the same interface as CasaMSSource."""

    def __init__(self, msd):
        self.msd = dict(msd)
        self.nrow = int(np.asarray(self.msd["UVW"]).shape[0])

    def index(self):
        return {k: v for k, v in self.msd.items()
                if k not in ("DATA", "MODEL_DATA", "CORRECTED_DATA",
                             "UVW", "FLAG", "WEIGHT_SPECTRUM",
                             "WEIGHT", "SIGMA", "SIGMA_SPECTRUM")}

    def read_rows(self, rows, columns):
        rows = np.asarray(rows, np.int64)
        return {c: np.asarray(self.msd[c])[rows] for c in columns
                if c in self.msd}


def open_ms_source(ms):
    """MS source for a path (npz file or CASA MS directory) or an
    in-memory column dict."""
    if isinstance(ms, (str, bytes)) or hasattr(ms, "__fspath__"):
        p = str(ms)
        if Path(p).is_dir():
            return CasaMSSource(p)
        if not p.endswith(".npz"):
            p = p + ".npz"
        with np.load(p, allow_pickle=False) as f:
            return DictMSSource({k: f[k] for k in f.files})
    return DictMSSource(ms)


def update_ms_column(path, name, values):
    ms = read_ms(path)
    ms[name] = values
    p = str(path)
    if not p.endswith(".npz"):
        p = p + ".npz"
    np.savez(p, **ms)


def point_source_vis(uvw, freq, cube, cell_rad):
    """Visibilities of a (nchan, nx, ny) cube of point sources,
    evaluated directly in float64 on the host as a sum over its
    nonzero pixels: vis = sum_s I_s exp(-2 pi i (u l + v m + w (n-1))
    f/c), the exact-DFT convention of pfb_tpu.ops.dft with the w-term
    on. Costs nsource x nvis instead of the npix x nvis of an image
    DFT."""
    from pfb_tpu.ops.dft import LIGHTSPEED

    uvw = np.asarray(uvw, np.float64)
    nchan, nx, ny = cube.shape
    out = np.zeros((uvw.shape[0], nchan), np.complex128)
    for c in range(nchan):
        ix, iy = np.nonzero(cube[c])
        if ix.size == 0:
            continue
        l = (ix - nx // 2) * cell_rad
        m = (iy - ny // 2) * cell_rad
        eps = l**2 + m**2
        nm1 = -eps / (np.sqrt(1.0 - eps) + 1.0)
        cyc = (uvw[:, 0:1] * l + uvw[:, 1:2] * m + uvw[:, 2:3] * nm1) * \
            (freq[c] / LIGHTSPEED)
        out[:, c] = np.exp(-2j * np.pi * cyc) @ cube[c, ix, iy]
    return out


def simulate_ms(path, nant=7, ntime=8, nchan=4, nsource=10, fov_deg=1.0,
                seed=420, gains=False, ncorr=2, pol="linear",
                duration_h=1.0, extent=1000.0, noise=0.0, nscan=1,
                gain_mode="diag", gain_nt=None, gain_nf=None,
                fullpol=False):
    """Simulate an observation with point sources (and optionally smooth
    gain corruptions) and write it as an npz MS. Returns
    (model_cube, Ix, Iy, nx, cell_rad, jones) — the ground truth the
    e2e tests assert against (mirrors upstream test_klean.py:71-175).

    nscan > 1 splits the unique times into scans (SCAN_NUMBER column);
    gain_mode="full" corrupts with full 2x2 Jones (small leakages,
    QuartiCal (t, a, f, dir, 2, 2) layout, forces ncorr=4); gain_nt /
    gain_nf put the gains on a coarser (time, chan) grid than the data
    so init's gain binning is exercised. fullpol=True draws polarised
    sources (|Q|,|U|,|V| < I, ncorr=4) and the returned model has a
    leading Stokes axis (4, nband, nx, ny) in I,Q,U,V order (mirrors
    upstream tests/test_polproducts.py:11-129).
    """
    from pfb_tpu.utils.simulation import (image_size_for,
                                          point_source_model, simulate_obs)

    obs = simulate_obs(nant=nant, ntime=ntime, nchan=nchan, seed=seed,
                       duration_h=duration_h, extent=extent)
    nx, cell_rad = image_size_for(obs, fov_deg=fov_deg, srf=2.0)
    model, Ix, Iy = point_source_model(nx, nx, obs.freq, nsource=nsource,
                                       seed=seed)
    nrow = obs.uvw.shape[0]

    def degrid_cube(cube):
        return point_source_vis(obs.uvw, obs.freq, cube, cell_rad)

    if fullpol:
        # polarised fractions per source, constant over the cube
        prng = np.random.default_rng(seed + 1)
        frac = prng.uniform(-0.4, 0.4, size=(3, Ix.size))
        stokes = np.zeros((4,) + model.shape)
        stokes[0] = model
        for s, (i, j) in enumerate(zip(Ix, Iy)):
            for p in range(3):
                stokes[1 + p, :, i, j] = frac[p, s] * model[:, i, j]
        vI, vQ, vU, vV = (degrid_cube(stokes[p]) for p in range(4))
        data = np.zeros((nrow, nchan, 4), dtype=np.complex128)
        if pol == "linear":
            data[..., 0] = vI + vQ
            data[..., 1] = vU + 1j * vV
            data[..., 2] = vU - 1j * vV
            data[..., 3] = vI - vQ
        else:  # circular: RR = I+V, RL = Q+iU, LR = Q-iU, LL = I-V
            data[..., 0] = vI + vV
            data[..., 1] = vQ + 1j * vU
            data[..., 2] = vQ - 1j * vU
            data[..., 3] = vI - vV
        model = stokes
        ncorr = 4
    else:
        vis = degrid_cube(model)
        if gains and gain_mode == "full":
            ncorr = 4
        data = np.zeros((nrow, nchan, ncorr), dtype=np.complex128)
        data[..., 0] = vis
        data[..., -1] = vis

    rng = np.random.default_rng(seed)
    utime = np.unique(obs.time)
    tbin_map = np.searchsorted(utime, obs.time)
    gnt = int(gain_nt) if gain_nt else ntime
    gnf = int(gain_nf) if gain_nf else nchan
    gain_time = utime.reshape(gnt, -1).mean(-1) if gnt != ntime \
        else utime
    gain_freq = obs.freq.reshape(gnf, -1).mean(-1) if gnf != nchan \
        else obs.freq
    # (time, chan) bin of each data point on the gain grid
    gt_of_row = np.clip(np.searchsorted(gain_time, obs.time,
                                        side="right") - 1, 0, gnt - 1)
    gf_of_chan = np.clip(np.searchsorted(gain_freq, obs.freq,
                                         side="right") - 1, 0, gnf - 1)

    def smooth(amp0, amp1):
        t = np.linspace(0, 1, gnt)
        nu = np.linspace(0, 1, gnf)
        amp = amp0 + amp1 * (
            np.sin(2 * np.pi * (t[:, None] + rng.random())) *
            np.cos(2 * np.pi * (nu[None, :] + rng.random())))
        phase = 0.3 * np.sin(
            2 * np.pi * (t[:, None] * rng.random() + nu[None, :] *
                         rng.random() + rng.random()))
        return amp * np.exp(1j * phase)

    if gains and gain_mode == "full":
        # full 2x2: dominant diagonal + small leakage terms
        jones = np.zeros((gnt, nant, gnf, 1, 2, 2), np.complex128)
        for p in range(nant):
            jones[:, p, :, 0, 0, 0] = smooth(1.0, 0.1)
            jones[:, p, :, 0, 1, 1] = smooth(1.0, 0.1)
            jones[:, p, :, 0, 0, 1] = smooth(0.0, 0.02)
            jones[:, p, :, 0, 1, 0] = smooth(0.0, 0.02)
        gp = jones[gt_of_row, obs.ant1.astype(int)][:, gf_of_chan, 0]
        gq = jones[gt_of_row, obs.ant2.astype(int)][:, gf_of_chan, 0]
        # V_pq = G_p V G_q^H
        V = np.zeros((nrow, nchan, 2, 2), np.complex128)
        V[..., 0, 0] = data[..., 0]
        V[..., 1, 1] = data[..., -1]
        if data.shape[-1] == 4:
            V[..., 0, 1] = data[..., 1]
            V[..., 1, 0] = data[..., 2]
        out = np.einsum("rcij,rcjk,rclk->rcil", gp, V, np.conj(gq))
        data = out.reshape(nrow, nchan, 4)
    elif gains:
        jones = np.zeros((gnt, nant, gnf, 1, 2), dtype=np.complex128)
        for p in range(nant):
            for c in range(2):
                jones[:, p, :, 0, c] = smooth(1.0, 0.1)
        gp = jones[gt_of_row, obs.ant1.astype(int)][:, gf_of_chan, 0]
        gq = jones[gt_of_row, obs.ant2.astype(int)][:, gf_of_chan, 0]
        data[..., 0] = gp[..., 0] * np.conj(gq[..., 0]) * data[..., 0]
        data[..., -1] = gp[..., 1] * np.conj(gq[..., 1]) * data[..., -1]
        if data.shape[-1] == 4:
            data[..., 1] = gp[..., 0] * np.conj(gq[..., 1]) * \
                data[..., 1]
            data[..., 2] = gp[..., 1] * np.conj(gq[..., 0]) * \
                data[..., 2]
    else:
        jones = None

    if noise:
        data += noise * (rng.standard_normal(data.shape) +
                         1j * rng.standard_normal(data.shape))

    scan = np.zeros(nrow, np.int32)
    if nscan > 1:
        bounds = np.array_split(np.arange(utime.size), nscan)
        for si, b in enumerate(bounds):
            scan[np.isin(tbin_map, b)] = si

    write_ms(path,
             DATA=data,
             UVW=obs.uvw,
             TIME=obs.time,
             ANTENNA1=obs.ant1,
             ANTENNA2=obs.ant2,
             FLAG=np.zeros(data.shape, bool),
             WEIGHT_SPECTRUM=np.ones(data.shape),
             FREQ=obs.freq,
             FIELD_ID=np.zeros(nrow, np.int32),
             DATA_DESC_ID=np.zeros(nrow, np.int32),
             SCAN_NUMBER=scan,
             RA=np.array(obs.ra),
             DEC=np.array(obs.dec),
             POLTYPE=np.array(pol))
    if jones is not None:
        np.savez(str(path) + ".gains.npz", jones=jones,
                 gain_time=gain_time, gain_freq=gain_freq)
    return model, Ix, Iy, nx, cell_rad, jones
