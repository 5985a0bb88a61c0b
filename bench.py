"""Benchmark of the imaging operators on one GPU, at the deployment
size of ``chip_smoke.py`` (4096^2 x 8 bands, float32).

    python bench.py

Measures, with ``block_until_ready`` around each timed call:

- the PSF-Hessian matvec (XLA rFFT convolve, i.e. cuFFT) on an
  (8, 4096, 4096) cube with psf_oversize=2, and its share of the
  bandwidth bound: the op moves ~5 padded cubes (pad write, rfft
  read+write, irfft read+write) of 8 x 8192^2 float32 = 10.7 GB,
  3.2 ms at 3.35 TB/s (the H100 SXM data sheet's HBM rate);
- fixed-iteration fused PCG on that operator (iterations/s);
- the ``wgrid`` gridder (XLA scatter-add), adjoint and forward on the
  deployment's uv coverage (64 antennas x 500 times x 8 channels =
  8.06M visibilities, epsilon 1e-5, w-gridding on), in Mvis/s, with
  its host plan time.

Refuses to run without a GPU. Prints the card's name and power limit,
then one JSON line.
"""

import json
import sys
import time

import numpy as np

from chip_smoke import DEPLOYMENT, gpu_name_and_power

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def timed(fn, *args, reps=3):
    """(seconds of the fastest of ``reps`` calls, all times)."""
    import jax
    jax.block_until_ready(fn(*args))   # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def bench_matvec(nband=8, nx=4096, pcg_iters=50):
    import jax
    import jax.numpy as jnp

    from pfb_tpu.ops.fft import make_psfhat
    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.opt.pcg import make_pcg_bands_fused

    nxp = 2 * nx
    # a delta plus an off-centre tap: an uneven PSF, so the transfer
    # function is complex like a w-gridded PSF's
    psf = jnp.zeros((nband, nxp, nxp), jnp.float32)
    psf = psf.at[:, nx, nx].set(0.5).at[:, nx + 3, nx + 1].set(0.01)
    psfhat = make_psfhat(psf)
    del psf
    hess = make_psf_convolve(psfhat, nxp)
    x = jnp.full((nband, nx, nx), 1e-3, jnp.float32)
    best, ts = timed(hess, x, reps=10)
    bound = 5 * nband * nxp * nxp * 4 / HBM_BYTES_PER_S

    solve = make_pcg_bands_fused(hess.apply, tol=0.0, maxit=pcg_iters,
                                 minit=pcg_iters, backtrack=False)
    b = hess(x)
    t_pcg, _ = timed(solve, b, jnp.zeros_like(b), hess.consts, reps=2)
    return {"matvec_ms": best * 1e3,
            "matvec_ms_all": [t * 1e3 for t in ts],
            "matvec_bound_ms": bound * 1e3,
            "matvec_share_of_bound": bound / best,
            "pcg_iters_per_s": pcg_iters / t_pcg}


def deployment_uv():
    """uv coverage of the chip_smoke deployment (64 antennas, 500
    times, 8 channels) and its 4096^2 cell size."""
    from pfb_tpu.ops.dft import LIGHTSPEED
    from pfb_tpu.utils.simulation import simulate_obs
    d = DEPLOYMENT
    obs = simulate_obs(nant=d["nant"], ntime=d["ntime"],
                       nchan=d["nchan"], extent=d["extent"],
                       seed=d["seed"])
    uv_max = np.abs(obs.uvw[:, :2]).max()
    cell = 1.0 / (2 * uv_max * obs.freq.max() / LIGHTSPEED) / 2.0
    return obs.uvw, obs.freq, cell


def bench_gridder(nx=4096, epsilon=1e-5):
    import jax
    import jax.numpy as jnp

    from pfb_tpu.ops.gridder import Gridder

    uvw, freq, cell = deployment_uv()
    nvis = uvw.shape[0] * freq.size
    rng = np.random.default_rng(0)
    vr = jnp.asarray(rng.normal(size=(uvw.shape[0], freq.size)),
                     jnp.float32)
    vi = jnp.asarray(rng.normal(size=(uvw.shape[0], freq.size)),
                     jnp.float32)
    t0 = time.perf_counter()
    g = Gridder("wgrid", uvw, freq, nx=nx, ny=nx, cell=cell,
                epsilon=epsilon, do_wgridding=True)
    t_plan = time.perf_counter() - t0
    t_adj, _ = timed(lambda a, b: g.vis2dirty((a, b)), vr, vi)
    img = g.vis2dirty((vr, vi))
    t_fwd, _ = timed(g.dirty2vis, img)
    stats = jax.devices()[0].memory_stats() or {}
    return {"nvis": nvis, "nw": g.nw, "plan_s": t_plan,
            "adjoint_s": t_adj, "forward_s": t_fwd,
            "adjoint_Mvis_per_s": nvis / t_adj / 1e6,
            "forward_Mvis_per_s": nvis / t_fwd / 1e6,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1
    from pfb_tpu.parallel.runtime import enable_compile_cache
    cache = enable_compile_cache()
    dev = jax.devices()[0]
    print(f"gpu: {gpu_name_and_power()}", flush=True)
    print(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
          f"compile cache {cache}", flush=True)

    result = {"device": {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())}}
    result["matvec"] = bench_matvec()
    print(json.dumps(result["matvec"]), flush=True)
    result["gridder"] = bench_gridder()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
