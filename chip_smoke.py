"""Smoke run of the imaging main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # band-sharded spotless on four

Drives the workers' Python entry points (init -> grid -> spotless ->
klean -> restore) on a MeerKAT-like L-band continuum observation at
the widths users image: 64 antennas (~4 km extent), 500 times, 8
channels imaged as 8 bands (8.06 M visibilities, 2 correlations), 10
point sources, a 4096^2 image with psf_oversize=2, robust 0, epsilon
1e-5 with w-gridding, float32. Only the iteration counts are cut
(``CUTS``), and the first output lines say so.

Phases: device check; the chip-marked parity tests
(tests/test_chip.py) in this process; simulate; init + grid; spotless;
klean; restore; and a consistency gate — the spotless MODEL re-gridded
by the grid worker must reproduce spotless's residual to 1e-4 of the
dirty image's peak. Every phase prints its wall and compile seconds and
the device's peak memory. Any failure exits non-zero. The last line is
one JSON object naming the device.

``--four-cards`` runs only the band-sharded phase: the exact residual
and spotless_dist over a 4-card ('band',) mesh (2 bands per card)
against the same on card 0, with the per-card collective-free phase
times. The exact residuals, and the models after one major iteration,
agree to 1e-5 of their peaks; the models after ``niter`` iterations
are printed beside the one-card run-to-run spread.

Refuses to run without a GPU. One process uses the cards; the card's
name and power limit come from nvidia-smi in a child process that
never imports JAX.
"""

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the deployment (see the module docstring)
DEPLOYMENT = dict(nant=64, ntime=500, nchan=8, nsource=10,
                  extent=4000.0, nx=4096, epsilon=1e-5, robustness=0.0,
                  bases="self,db1,db2", nlevels=3, seed=420,
                  backend="wgrid")
# iteration counts, cut to keep a cold run well inside 20 minutes
CUTS = dict(niter=2, pd_maxit=100)


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    """nvidia-smi's name and power limit of the cards, read by a child
    process that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


class Phases:
    """Wall seconds, backend-compile seconds and peak device memory per
    phase (diagnostics, not metrics)."""

    def __init__(self):
        import jax
        self.compile_s = 0.0
        self.rows = []

        def listener(event, duration, **kw):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(listener)

    def peak_gb(self):
        import jax
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in jax.local_devices()]
        return max(peaks) / 1e9

    def run(self, name, fn, *args, **kw):
        import jax
        c0, t0 = self.compile_s, time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        log(f"phase {name}: wall {wall:.3f} s, compile {comp:.3f} s, "
            f"peak device memory {self.peak_gb():.2f} GB")
        self.rows.append((name, wall, comp))
        return out


def check_device():
    """Phase 1. Returns the device or None (after saying why)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return None
    import jaxlib
    from pfb_tpu.parallel.runtime import enable_compile_cache
    cache = enable_compile_cache()
    log(f"gpu: {gpu_name_and_power()}")
    log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}; "
        f"jax {jax.__version__}; jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache: {cache}")
    for mod in ("sympy", "click", "yaml"):
        try:
            importlib.import_module(mod)
            ok = "imports"
        except ImportError:
            ok = "missing"
        log(f"optional package {mod}: {ok}")
    return dev


def chip_tests():
    """Phase 2: the chip-marked parity tests, in this process."""
    import pytest

    class Count:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                self.passed += report.passed
                self.failed += report.failed

    c = Count()
    rc = pytest.main(["-q", "-s", "-m", "chip", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_chip.py")],
                     plugins=[c])
    if rc != 0 or c.failed or c.passed == 0:
        raise RuntimeError(f"chip tests: rc={rc}, passed={c.passed}, "
                           f"failed={c.failed}")
    return c.passed


def simulate(cfg, workdir):
    """Phase 3: the observation, written as an npz MS."""
    import numpy as np

    from pfb_tpu.ops.dft import LIGHTSPEED
    from pfb_tpu.utils.ms import simulate_ms
    from pfb_tpu.utils.simulation import simulate_obs

    obs = simulate_obs(nant=cfg["nant"], ntime=cfg["ntime"],
                       nchan=cfg["nchan"], extent=cfg["extent"],
                       seed=cfg["seed"])
    uv_max = np.abs(obs.uvw[:, :2]).max()
    cell = 1.0 / (2 * uv_max * obs.freq.max() / LIGHTSPEED) / 2.0
    fov = (cfg["nx"] + 0.5) * np.rad2deg(cell)
    ms = os.path.join(workdir, "obs.npz")
    _, _, _, nx, _, _ = simulate_ms(
        ms, nant=cfg["nant"], ntime=cfg["ntime"], nchan=cfg["nchan"],
        nsource=cfg["nsource"], fov_deg=fov, extent=cfg["extent"],
        seed=cfg["seed"], gains=False)
    assert nx == cfg["nx"], (nx, cfg["nx"])
    nvis = obs.uvw.shape[0] * cfg["nchan"]
    log(f"observation: {obs.uvw.shape[0]} rows x {cfg['nchan']} "
        f"channels = {nvis} visibilities, 2 correlations, "
        f"field {fov:.3f} deg")
    return ms, fov


def grid_kw(cfg):
    return dict(nx=cfg["nx"], ny=cfg["nx"], robustness=cfg["robustness"],
                psf_oversize=2.0, epsilon=cfg["epsilon"],
                do_wgridding=True, backend=cfg["backend"])


def init_and_grid(cfg, ms, out):
    """Phase 4: init -> grid (DIRTY, PSF, PSFHAT)."""
    from pfb_tpu.workers.grid import _grid
    from pfb_tpu.workers.init import _init
    xds = _init(ms=ms, output_filename=out, channels_per_image=1,
                precision="single")
    dds = _grid(xdsi=xds, output_filename=out, suffix="main", psf=True,
                residual=False, **grid_kw(cfg))
    return xds, dds


def spotless(cfg, dds, out, **kw):
    from pfb_tpu.workers.spotless import _spotless
    return _spotless(ddsi=[dict(d) for d in dds], output_filename=out,
                     suffix="main", niter=cfg["niter"],
                     pd_maxit=cfg["pd_maxit"], epsilon=cfg["epsilon"],
                     backend=cfg["backend"], bases=cfg["bases"],
                     nlevels=cfg["nlevels"], verbose=1, **kw)


def klean(cfg, dds, out):
    from pfb_tpu.workers.klean import _klean
    return _klean(ddsi=[dict(d) for d in dds], output_filename=out,
                  suffix="klean", niter=cfg["niter"],
                  epsilon=cfg["epsilon"], backend=cfg["backend"],
                  verbose=1)


def restore(out):
    from pfb_tpu.workers.restore import _restore
    return _restore(output_filename=out, suffix="main")


def regrid_residual(cfg, xds, model, out):
    """Phase 8's re-grid: the grid worker's RESIDUAL of ``model`` (one
    image per band), normalised like spotless's residual cube."""
    import numpy as np

    from pfb_tpu.workers.grid import _grid
    freqs = np.unique([ds["freq_out"] for ds in xds])
    xdm = []
    for ds in xds:
        d = dict(ds)
        d["MODEL"] = model[int(np.where(freqs == ds["freq_out"])[0][0])]
        xdm.append(d)
    dds_t = _grid(xdsi=xdm, output_filename=None, write=False,
                  dirty=False, psf=False, residual=True, **grid_kw(cfg))
    wsum = sum(float(d["WSUM"][0]) for d in dds_t)
    res = np.zeros(model.shape)
    for d in dds_t:
        res[d["bandid"]] += np.asarray(d["RESIDUAL"], np.float64)
    return res / wsum


def memory_report(cfg, dds):
    """compiled.memory_analysis() of the spotless major-iteration
    programs at the deployment's shapes (lowered from shapes only)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.ops.psi import make_psi, psi_dot, psi_hdot
    from pfb_tpu.opt.primal_dual import make_primal_dual_fused

    nband = len({d["bandid"] for d in dds})
    nx = cfg["nx"]
    nxp, nyp = dds[0]["PSF"].shape
    f32 = jnp.float32
    sd = jax.ShapeDtypeStruct
    psfhat = sd((nband, nxp, nyp // 2 + 1), jnp.complex64)
    bases = tuple(cfg["bases"].split(","))
    psi = make_psi(nx, nx, bases, cfg["nlevels"])
    conv = make_psf_convolve(jnp.zeros((1, 2, 2), jnp.complex64), nyp)
    pd = make_primal_dual_fused(conv.apply, partial(psi_dot, psi=psi),
                                partial(psi_hdot, psi=psi), len(bases),
                                1.0, maxit=cfg["pd_maxit"])
    cube = sd((nband, nx, nx), f32)
    args = (cube, sd((nband, len(bases), psi.Nymax, psi.Nxmax), f32),
            cube, sd((len(bases), psi.Nymax, psi.Nxmax), f32),
            sd((), f32), sd((), f32), sd((1, 1, 1), f32),
            {"psfhat": psfhat, "beam": None})
    for name, fn, a in (
            ("primal-dual backward step", pd, args),
            ("PSF-Hessian data step",
             jax.jit(conv.apply), (cube, {"psfhat": psfhat,
                                          "beam": None}))):
        ma = fn.lower(*a).compile().memory_analysis()
        log(f"memory_analysis {name}: arguments "
            f"{ma.argument_size_in_bytes / 1e9:.2f} GB, outputs "
            f"{ma.output_size_in_bytes / 1e9:.2f} GB, temporaries "
            f"{ma.temp_size_in_bytes / 1e9:.2f} GB, code "
            f"{ma.generated_code_size_in_bytes / 1e6:.1f} MB")


def report_deconv(name, dds, model, resid):
    """Print a deconvolver's model and residual peaks; fail unless both
    are finite and the MFS residual peak fell below the dirty image's."""
    import numpy as np
    wsum = sum(float(d["WSUM"][0]) for d in dds)
    dirty_peak = np.abs(sum(np.asarray(d["DIRTY"], np.float64)
                            for d in dds) / wsum).max()
    rpeak = np.abs(np.asarray(resid, np.float64).sum(axis=0)).max()
    log(f"{name}: model peak {np.abs(model).max():.4e}, MFS residual "
        f"peak {rpeak:.4e} (dirty {dirty_peak:.4e})")
    if not (np.isfinite(model).all() and np.isfinite(resid).all()
            and rpeak < dirty_peak):
        raise RuntimeError(f"{name} did not reduce the residual")


def run_single(cfg, workdir, ph, run_tests=True):
    """Phases 2-8 on one card. Returns the consistency error."""
    import numpy as np

    if run_tests:
        n = ph.run("chip tests", chip_tests)
        log(f"chip tests: {n} passed")
    ms, _ = ph.run("simulate", simulate, cfg, workdir)
    out = os.path.join(workdir, "out")
    xds, dds = ph.run("init+grid", init_and_grid, cfg, ms, out)
    model, resid = ph.run("spotless", spotless, cfg, dds, out)
    report_deconv("spotless", dds, model, resid)
    kmodel, kresid = ph.run("klean", klean, cfg, dds, out)
    report_deconv("klean", dds, kmodel, kresid)
    ph.run("restore", restore, out)
    res_t = ph.run("regrid model", regrid_residual, cfg, xds,
                   np.asarray(model), out)
    wsum = sum(float(d["WSUM"][0]) for d in dds)
    dirty_mfs = sum(np.asarray(d["DIRTY"], np.float64)
                    for d in dds) / wsum
    err = float(np.abs(res_t - np.asarray(resid, np.float64)).max()
                / np.abs(dirty_mfs).max())
    log(f"consistency: max|regrid - spotless residual| / "
        f"max|dirty_mfs| = {err:.3e} (gate 1e-4)")
    if not err <= 1e-4:
        raise RuntimeError(f"residual consistency {err:.3e} > 1e-4")
    memory_report(cfg, dds)
    return err


def max_rel(a, ref):
    """max|a - ref| / max|ref| in float64."""
    import numpy as np
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def ulp_perturbed(dds, seed=0):
    """Copies of the datasets with every DIRTY pixel moved one ulp up
    or down at random."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for ds in dds:
        d = np.asarray(ds["DIRTY"])
        to = np.where(rng.random(d.shape) < 0.5, -np.inf, np.inf)
        out.append(dict(ds, DIRTY=np.nextafter(d, to.astype(d.dtype))))
    return out


def hessnorm_of(dds):
    """The spotless workers' PSF-Hessian norm estimate (1.05 x the
    power method's), computed once so that compared runs share it."""
    import jax
    import jax.numpy as jnp

    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.opt.power_method import make_power_method_fused
    from pfb_tpu.workers.cubes import dds2cubes
    nband = len({d["bandid"] for d in dds})
    nx, ny = dds[0]["DIRTY"].shape
    _, _, _, _, psfhat, _, _, _ = dds2cubes(dds, nband, apparent=False)
    conv = make_psf_convolve(jnp.asarray(psfhat), dds[0]["PSF"].shape[-1])
    pm = make_power_method_fused(conv.apply, tol=1e-5, maxit=100)
    b0 = jax.random.normal(jax.random.PRNGKey(42), (nband, nx, ny))
    return float(pm(b0, conv.consts)[0]) * 1.05


def rounding_probes(cfg, dds, hessnorm, ph, model):
    """How far one card's spotless model (``model``, from ``dds``)
    moves under rounding alone: with every DIRTY pixel moved by one
    ulp, and with the bands in reverse order (another order of every
    band sum, in each solver iteration)."""
    import numpy as np
    nband = len({d["bandid"] for d in dds})
    rev = [dict(d, bandid=nband - 1 - int(d["bandid"])) for d in dds]
    m_ulp, _ = ph.run("spotless, card 0, DIRTY +-1 ulp", spotless, cfg,
                      ulp_perturbed(dds), None, hessnorm=hessnorm,
                      write=False)
    m_rev, _ = ph.run("spotless, card 0, bands reversed", spotless, cfg,
                      rev, None, hessnorm=hessnorm, write=False)
    return {"DIRTY +-1 ulp": max_rel(m_ulp, model),
            "bands reversed": max_rel(np.asarray(m_rev)[::-1], model)}


# the four-card gates: the exact residual and the models after one
# major iteration, where one card run twice gives the same model
FOUR_CARD_GATE = 1e-5


def run_four_cards(cfg, workdir, ph):
    """The band-sharded phase: the exact residual and spotless_dist over
    a 4-card band mesh vs the same on card 0.

    Gated at ``FOUR_CARD_GATE``: the band-sharded exact residual
    against the one-card operator on the same cube, and the models
    after one major iteration (the primal-dual solve from the same
    residual; only the band sums' reduction order differs), printed
    beside how far rounding alone moves the one-card model
    (:func:`rounding_probes`). After
    ``cfg['niter']`` iterations the exact residual's scatter-add
    atomics enter the second solve, so that agreement is printed beside
    the one-card run-to-run spread of the same run. Returns the gated
    numbers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pfb_tpu.ops.gridder import make_hessian_dds
    from pfb_tpu.parallel.dist import make_hessian_dds_dist
    from pfb_tpu.parallel.mesh import band_sharding, make_mesh
    from pfb_tpu.workers.spotless import _spotless_dist

    ncard = len(jax.devices())
    if ncard < 4:
        raise RuntimeError(f"--four-cards needs 4 cards, found {ncard}")
    mesh = make_mesh(nband=4, nspace=1, devices=jax.devices()[:4])
    ms, _ = ph.run("simulate", simulate, cfg, workdir)
    out = os.path.join(workdir, "out")
    _, dds = ph.run("init+grid", init_and_grid, cfg, ms, out)
    nband = len({d["bandid"] for d in dds})
    nx = cfg["nx"]
    wsum = sum(float(d["WSUM"][0]) for d in dds)

    # the collective-free band-local phase: the exact residual
    x = np.random.default_rng(1).random((nband, nx, nx)).astype(
        np.float32)
    kw = dict(use_beam=False, backend=cfg["backend"],
              epsilon=cfg["epsilon"])
    h4 = make_hessian_dds_dist(mesh, dds, nband, wsum, nx, nx, **kw)
    x4 = jax.device_put(jnp.asarray(x), band_sharding(mesh))
    ph.run("exact residual, 4 cards (warm)", h4, x4)
    r4 = np.asarray(ph.run("exact residual, 4 cards", h4, x4))
    del h4, x4
    h1 = make_hessian_dds(dds, nband, wsum, nx, nx, **kw)
    r1 = np.asarray(ph.run("exact residual, 1 card (warm)", h1,
                           jnp.asarray(x)))
    r1b = np.asarray(ph.run("exact residual, 1 card", h1,
                            jnp.asarray(x)))
    del h1
    res = {"exact residual": max_rel(r4, r1)}
    log(f"exact residual: max|h_4(x) - h_1(x)| / max|h_1(x)| = "
        f"{res['exact residual']:.3e} (gate {FOUR_CARD_GATE:g}); one "
        f"card twice: {max_rel(r1b, r1):.3e}")
    del r4, r1, r1b

    # one hessnorm for both runs, so the comparison sees only the
    # reduction order
    hessnorm = hessnorm_of(dds)

    for niter in sorted({1, cfg["niter"]}):
        c = dict(cfg, niter=niter)
        m4, _ = ph.run(f"spotless_dist niter={niter}, 4 cards",
                       _spotless_dist, mesh=mesh,
                       ddsi=[dict(d) for d in dds], niter=niter,
                       pd_maxit=c["pd_maxit"], epsilon=c["epsilon"],
                       backend=c["backend"], bases=c["bases"],
                       nlevels=c["nlevels"], hessnorm=hessnorm,
                       write=False, verbose=1)
        m1, _ = ph.run(f"spotless niter={niter}, card 0", spotless, c,
                       dds, None, hessnorm=hessnorm, write=False)
        m1b, _ = ph.run(f"spotless niter={niter}, card 0 again",
                        spotless, c, dds, None, hessnorm=hessnorm,
                        write=False)
        rel = max_rel(m4, m1)
        spread = f"one card twice: {max_rel(m1b, m1):.3e}"
        if niter == 1:
            res["model niter=1"] = rel
            spread += "; " + "; ".join(
                f"one card, {k}: {v:.3e}" for k, v in
                rounding_probes(c, dds, hessnorm, ph, m1).items())
        gate = f"gate {FOUR_CARD_GATE:g}" if niter == 1 else "not gated"
        log(f"four cards vs one, niter={niter}: max|model_4 - model_1| "
            f"/ max|model_1| = {rel:.3e} ({gate}); {spread}")
    bad = {k: v for k, v in res.items() if not v <= FOUR_CARD_GATE}
    if bad:
        raise RuntimeError(f"four cards disagree with one: {bad}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the band-sharded phase on 4 cards")
    ap.add_argument("--workdir", default=os.path.join(REPO,
                                                      ".chip_smoke"),
                    help="scratch directory, removed at the end")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    dev = check_device()
    if dev is None:
        return 1
    cfg = dict(DEPLOYMENT, **CUTS)
    log(f"deployment: {json.dumps(cfg)}")
    log(f"cut for run time: niter={cfg['niter']} major iterations, "
        f"pd_maxit={cfg['pd_maxit']}; no width is cut")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    ph = Phases()
    try:
        if args.four_cards:
            run_four_cards(cfg, args.workdir, ph)
        else:
            run_single(cfg, args.workdir, ph)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    import jax
    log(f"gpu: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
