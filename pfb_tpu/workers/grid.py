"""grid worker: xds -> dds (dirty/PSF/PSFHAT/weights per (time, band)).

JAX equivalent of pfb/workers/grid.py:124-588: image sizing from
uv_max (cell = cell_N / super_resolution_factor, even 5-smooth npix),
ES-kernel uv counts -> Briggs robust weights, and the one-pass
image_data_products per dataset. The xds beam is resampled onto the
image grid per dataset (reference grid.py:404-412).
"""

import numpy as np

from pfb_tpu.ops.dft import LIGHTSPEED
from pfb_tpu.ops.fft import good_even_size
from pfb_tpu.ops.gridder import DEFAULT_BACKEND, image_data_products
from pfb_tpu.ops.weighting import compute_counts, filter_extreme_counts
from pfb_tpu.utils import dstore


def _grid(xdsi=None, output_filename=None, product="I", suffix="main",
          nband=None, field_of_view=None, cell_size=None, nx=None,
          ny=None, super_resolution_factor=2.0, robustness=None,
          dirty=True, psf=True, psf_oversize=2.0, residual=True,
          weight=True, filter_extreme_counts_flag=False,
          filter_level=10.0, filter_nbox=None, l2reweight_dof=None,
          overwrite=True, write=True, backend=DEFAULT_BACKEND,
          epsilon=1e-7,
          do_wgridding=True, double_accum=True,
          transfer_model_from=None, use_best_model=False, target=None,
          x0=0.0, y0=0.0, xds=None, fits_mfs=False, fits_cubes=False,
          **kw):
    """Returns the list of dds datasets (and writes
    ``{output_filename}_{PRODUCT}_{suffix}.dds`` unless write=False).

    ``transfer_model_from`` names an mds store (or passes its dict):
    the fitted component model is rendered onto each dataset's image
    grid at its (time_out, freq_out) and the RESIDUAL is computed at
    grid time (reference grid.py:308-334); ``use_best_model`` degrids
    MODEL_BEST instead of MODEL when no mds is given (grid.yaml).
    ``epsilon``/``do_wgridding``/``double_accum`` plumb gridder
    accuracy to the backend (gridding.yml:1-5). ``target`` recentres
    the image on an ephemeris body or 'HH:MM:SS,DD:MM:SS' by setting
    (x0, y0) from the phase-centre offset (reference grid.py:371)."""
    if xdsi is None:
        path = xds if isinstance(xds, str) and xds else \
            f"{output_filename}_{product.upper()}.xds"
        xds = dstore.read_store(path)
    else:
        xds = xdsi

    fields = kw.get("fields")
    if fields is not None:
        from pfb_tpu.workers.init import _idlist
        fields = _idlist(fields)
        xds = [ds for ds in xds if ds.get("fieldid", 0) in fields]
    fids = {ds.get("fieldid", 0) for ds in xds}
    if len(fids) > 1:
        raise ValueError(
            f"xds spans fields {sorted(fids)} — image one field per "
            "grid run (--fields) or solve jointly with "
            "ops.gridder.make_hess_vis_dct + opt.pcg.cg_dct")

    nband_in = np.unique([ds["freq_out"] for ds in xds]).size
    if nband is not None and nband != nband_in:
        # channel re-binning (reference grid.py:203-214)
        from pfb_tpu.workers.concat import concat_chan
        xds = concat_chan(xds, nband)
    if kw.get("concat_row"):
        from pfb_tpu.workers.concat import concat_row
        xds = concat_row(xds)
    freqs_out = np.unique([ds["freq_out"] for ds in xds])
    times_out = np.unique([ds["time_out"] for ds in xds])
    nband = freqs_out.size

    # image size from uv_max (reference grid.py:226-264)
    uv_max = max(np.abs(ds["UVW"][:, :2]).max() for ds in xds)
    max_freq = max(ds["FREQ"].max() for ds in xds)
    cell_N = 1.0 / (2 * uv_max * max_freq / LIGHTSPEED)
    if cell_size is not None:
        cell_rad = cell_size * np.pi / 60 / 60 / 180
        if cell_N / cell_rad < 1:
            raise ValueError("Requested cell size too large.")
    else:
        cell_rad = cell_N / super_resolution_factor

    if nx is None:
        fov = field_of_view * 3600
        cell_arcsec = cell_rad * 60 * 60 * 180 / np.pi
        npix = good_even_size(int(fov / cell_arcsec))
        nx = ny = npix
    else:
        ny = ny if ny is not None else nx

    nx_psf = good_even_size(int(psf_oversize * nx))
    ny_psf = good_even_size(int(psf_oversize * ny))

    import jax.numpy as jnp

    real_type = xds[0]["WEIGHT"].dtype

    mds = transfer_model_from
    if isinstance(mds, (str, bytes)):
        mds = dstore.read_store(str(mds))[0]

    def launch(ds):
        """Dispatch one dataset's device products (async) — chunk k+1
        launches before chunk k's host materialisation so device
        gridding overlaps host I/O (SURVEY.md 2.9.4 task pipelining;
        same launch/finish pattern as workers/fastim.py)."""
        bandid = int(np.where(freqs_out == ds["freq_out"])[0][0])
        timeid = int(np.where(times_out == ds["time_out"])[0][0])
        # geometry stays float64 on the host: the gridder plans every
        # position there (a float32 uvw is ~1e-2 rad of phase off at
        # 4 km baselines in L band)
        uvw = np.asarray(ds["UVW"])
        freq = np.asarray(ds["FREQ"])
        vis = jnp.asarray(ds["VIS"])
        wgt = jnp.asarray(ds["WEIGHT"])
        mask = jnp.asarray(ds["MASK"])

        x0_ds, y0_ds = x0, y0
        if target is not None:
            # recentre on the target: (x0, y0) = direction cosines of
            # the target w.r.t. this dataset's phase centre
            from pfb_tpu.utils.astrometry import (parse_target,
                                                  radec_to_lm)
            radec_t = parse_target(target,
                                   obs_time=ds.get("time_out"))
            x0_ds, y0_ds = radec_to_lm(radec_t,
                                       (ds["ra"], ds["dec"]))

        if robustness is not None:
            # host counts: a once-per-run pass
            from pfb_tpu.ops.weighting import compute_counts_host
            counts = jnp.asarray(compute_counts_host(
                np.asarray(uvw), np.asarray(freq), np.asarray(mask),
                nx, ny, cell_rad, cell_rad))
            if filter_extreme_counts_flag:
                counts = jnp.asarray(filter_extreme_counts(
                    np.asarray(counts), level=filter_level,
                    nbox=filter_nbox))
        else:
            counts = None

        model = ds.get("MODEL")
        if use_best_model and transfer_model_from is None:
            model = ds.get("MODEL_BEST", model)
        if mds is not None:
            from pfb_tpu.models.comps import eval_coeffs_to_slice
            model = eval_coeffs_to_slice(
                ds["time_out"], ds["freq_out"], mds["coefficients"],
                mds["location_x"], mds["location_y"],
                mds["parametrisation"], mds["params"], mds["texpr"],
                mds["fexpr"], mds["npix_x"], mds["npix_y"],
                mds["cell_rad_x"], mds["cell_rad_y"],
                mds.get("center_x", 0.0), mds.get("center_y", 0.0),
                nx, ny, cell_rad, cell_rad, x0_ds, y0_ds)
        out = image_data_products(
            uvw, freq, vis, wgt, mask, counts, nx, ny, nx_psf, ny_psf,
            cell_rad, cell_rad, model=model, robustness=robustness,
            x0=x0_ds, y0=y0_ds, l2reweight_dof=l2reweight_dof,
            do_dirty=dirty, do_psf=psf, do_weight=weight,
            do_residual=residual, backend=backend, epsilon=epsilon,
            do_wgridding=do_wgridding, double_accum=double_accum)
        return dict(ds=ds, out=out, counts=counts, model=model,
                    bandid=bandid, timeid=timeid, x0=x0_ds, y0=y0_ds)

    def finish(p):
        """Materialise a launched dataset's products to host (the
        blocking half; host beam evaluation rides here too)."""
        ds, out = p["ds"], p["out"]
        out_ds = {
            "ra": ds["ra"], "dec": ds["dec"], "x0": p["x0"],
            "y0": p["y0"],
            "cell_rad": cell_rad, "bandid": p["bandid"],
            "timeid": p["timeid"],
            "freq_out": ds["freq_out"], "time_out": ds["time_out"],
            "robustness": robustness, "product": product,
            "super_resolution_factor": super_resolution_factor,
            "field_of_view": field_of_view, "nx": nx, "ny": ny,
            "nx_psf": nx_psf, "ny_psf": ny_psf,
            "FREQ": np.asarray(ds["FREQ"]),
            "UVW": np.asarray(ds["UVW"]),
            "MASK": np.asarray(ds["MASK"]),
            "BEAM": _eval_ds_beam(ds, nx, ny, cell_rad, p["x0"],
                                  p["y0"], real_type),
            "WSUM": np.asarray(out["WSUM"]),
        }
        if dirty:
            out_ds["DIRTY"] = np.asarray(out["DIRTY"])
        if psf:
            out_ds["PSF"] = np.asarray(out["PSF"])
            # the dds stores complex PSFHAT as real/imag fields
            ph = out["PSFHAT"]
            out_ds["PSFHAT_real"] = np.asarray(ph.real)
            out_ds["PSFHAT_imag"] = np.asarray(ph.imag)
        if weight:
            out_ds["WEIGHT"] = np.asarray(out["WEIGHT"])
        if "RESIDUAL" in out:
            out_ds["RESIDUAL"] = np.asarray(out["RESIDUAL"])
        if p["model"] is not None:
            out_ds["MODEL"] = np.asarray(p["model"])
        if p["counts"] is not None:
            out_ds["COUNTS"] = np.asarray(p["counts"])
        return out_ds

    dds = []
    pending = None
    for ds in xds:
        nxt = launch(ds)
        if pending is not None:
            dds.append(finish(pending))
        pending = nxt
    if pending is not None:
        dds.append(finish(pending))

    if write and output_filename is not None:
        name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dstore.write_store(name, dds, overwrite=overwrite)
        if fits_mfs or fits_cubes:
            from pfb_tpu.utils.fits import dds2fits, dds2fits_mfs
            base = f"{output_filename}_{product.upper()}_{suffix}"
            cols = ["DIRTY"] if dirty else []
            cols += ["PSF"] if psf else []
            cols += ["RESIDUAL"] if any("RESIDUAL" in d
                                        for d in dds) else []
            for col in cols:
                if fits_mfs:
                    dds2fits_mfs(dds, col, base)
                if fits_cubes:
                    dds2fits(dds, col, base)
    return dds


def _eval_ds_beam(ds, nx, ny, cell_rad, x0, y0, real_type):
    """Evaluate the xds beam onto the image grid (reference
    grid.py:404-412 eval_beam)."""
    if "BEAM" not in ds or "l_beam" not in ds:
        return np.ones((nx, ny), real_type)
    from pfb_tpu.utils.beam import eval_beam
    cell_deg = np.rad2deg(cell_rad)
    l = (-(nx // 2) + np.arange(nx)) * cell_deg + np.rad2deg(x0)
    m = (-(ny // 2) + np.arange(ny)) * cell_deg + np.rad2deg(y0)
    return eval_beam(ds["BEAM"], ds["l_beam"], ds["m_beam"],
                     l, m).astype(real_type)


def psfhat_of(ds):
    """Reassemble the complex PSFHAT of a dds dataset."""
    return ds["PSFHAT_real"] + 1j * ds["PSFHAT_imag"]
