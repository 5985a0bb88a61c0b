"""degrid worker: mds component model -> MODEL_DATA-style column.

Equivalent of pfb/workers/degrid.py:21-236 + comps2vis
(pfb/operators/gridder.py:394-548): per (time-chunk, band) render the
fitted model onto the image grid at the chunk's mean (t, f) and degrid
to model visibilities, optionally accumulating into an existing column.
"""

import numpy as np

from pfb_tpu.models.comps import eval_coeffs_to_slice
from pfb_tpu.ops.gridder import DEFAULT_BACKEND, get_backend
from pfb_tpu.utils import dstore
from pfb_tpu.utils.ms import read_ms, update_ms_column


def _degrid(ms=None, mds=None, output_filename=None, product="I",
            suffix="main", model_column="MODEL_DATA",
            channels_per_image=None, integrations_per_image=-1,
            accumulate=False, backend=DEFAULT_BACKEND, epsilon=1e-7,
            do_wgridding=True, nx=None, ny=None,
            cell_rad=None, x0=0.0, y0=0.0, write=True, **kw):
    """Returns the model visibility column (nrow, nchan, ncorr) and
    writes it into the MS unless write=False."""
    import jax.numpy as jnp

    if isinstance(mds, str):
        mds = dstore.read_store(mds)[0]

    msd = read_ms(ms)
    uvw = msd["UVW"]
    time = msd["TIME"]
    freq = msd["FREQ"]
    data_shape = msd["DATA"].shape
    nrow, nchan, ncorr = data_shape

    utime = np.unique(time)
    ntime = utime.size
    tbin_map = np.searchsorted(utime, time)

    ipi = integrations_per_image
    if ipi in (0, -1, None):
        ipi = ntime
    cpi = channels_per_image
    if cpi in (0, -1, None):
        cpi = nchan

    # model grid defaults to the mds fit grid
    nx = nx or mds["npix_x"]
    ny = ny or mds["npix_y"]
    cell_rad = cell_rad or mds["cell_rad_x"]
    x0 = x0 or mds.get("center_x", 0.0)
    y0 = y0 or mds.get("center_y", 0.0)

    d2v, _ = get_backend(backend, epsilon, do_wgridding)

    vis = np.zeros((nrow, nchan), dtype=np.complex128)
    for t0 in range(0, ntime, ipi):
        rows = np.where((tbin_map >= t0) & (tbin_map < t0 + ipi))[0]
        tout = float(np.mean(utime[t0:t0 + ipi]))
        for c0 in range(0, nchan, cpi):
            csel = slice(c0, min(c0 + cpi, nchan))
            fout = float(np.mean(freq[csel]))
            image = eval_coeffs_to_slice(
                tout, fout, mds["coefficients"], mds["location_x"],
                mds["location_y"], mds["parametrisation"], mds["params"],
                mds["texpr"], mds["fexpr"],
                mds["npix_x"], mds["npix_y"],
                mds["cell_rad_x"], mds["cell_rad_y"],
                mds.get("center_x", 0.0), mds.get("center_y", 0.0),
                nx, ny, cell_rad, cell_rad, x0, y0)
            mvr, mvi = d2v(jnp.asarray(uvw[rows]),
                           jnp.asarray(freq[csel]),
                           jnp.asarray(image), cell_rad, cell_rad,
                           x0=x0, y0=y0, split=True)
            vis[np.ix_(rows, range(csel.start, csel.stop))] = \
                np.asarray(mvr) + 1j * np.asarray(mvi)

    model_vis = np.zeros(data_shape, dtype=np.complex128)
    model_vis[..., 0] = vis
    if ncorr > 1:
        model_vis[..., -1] = vis

    if write and ms is not None:
        if accumulate and model_column in msd:
            model_vis = model_vis + msd[model_column]
        update_ms_column(ms, model_column, model_vis)
    return model_vis
