"""Scaling-efficiency harness (BASELINE.json: >=80% matvec nnz/s at
N>=2 hosts): measures the band-sharded PSF-Hessian matvec rate per
chip at increasing mesh sizes and reports efficiency vs the 1-chip
rate.

One process drives every local card and sweeps the device counts
(1, 2, 4, ...); never open a card from a second process. Across hosts
run one process per host:
    python scripts/scaling_bench.py --coordinator host0:1234 \
        --num-processes N --process-id i
On a CPU with XLA_FLAGS=--xla_force_host_platform_device_count=8 the
virtual devices share cores, so CPU numbers validate the harness, not
the hardware.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_mesh(mesh, nband, nx, reps=3, chain=10):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pfb_tpu.ops.fft import make_psfhat
    from pfb_tpu.parallel.dist import hessian_psf_dist
    from pfb_tpu.parallel.mesh import band_sharding

    nxp = 2 * nx
    psf = jnp.zeros((nband, nxp, nxp), jnp.float32)
    psf = psf.at[:, nx, nx].set(0.5)
    sh = band_sharding(mesh)
    x = jax.device_put(jnp.full((nband, nx, nx), 1e-3, jnp.float32),
                       sh)
    psfhat = make_psfhat(psf, band_chunk=1)
    hargs = (jax.device_put(psfhat, sh),)
    hess = hessian_psf_dist(mesh, nxp)
    jax.block_until_ready(hess(x, *hargs))
    best = np.inf
    for _ in range(reps):
        z = x
        t0 = time.perf_counter()
        for _ in range(chain):
            z = hess(z, *hargs)
        jax.block_until_ready(z)
        best = min(best, (time.perf_counter() - t0) / chain)
    return 1.0 / best


def efficiency_table(results):
    """Weak-scaling efficiency per entry: (band-matvecs/s at n) /
    (n x band-matvecs/s at 1 device)."""
    base = results[0]["band_matvecs_per_s"]
    for r in results:
        r["efficiency"] = round(
            r["band_matvecs_per_s"] / (r["ndevices"] * base), 4)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--nband-per-device", type=int, default=1)
    ap.add_argument("--mode", default="weak",
                    choices=["weak", "strong"],
                    help="weak: nband grows with devices (per-device "
                    "work fixed; the pod-slice metric). strong: fixed "
                    "total cube sharded over 1..N devices — on a "
                    "virtual CPU mesh (devices share cores) this is "
                    "the meaningful check: ideal is FLAT wall time, "
                    "and efficiency = t1/tn measures pure shard_map/"
                    "collective overhead.")
    args = ap.parse_args()

    import jax

    from pfb_tpu.parallel.runtime import enable_compile_cache
    enable_compile_cache()
    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)

    from pfb_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    platform = devs[0].platform
    nx = args.nx or (4096 if platform == "gpu" else 256)

    results = []
    n = 1
    nband_fixed = len(devs) * args.nband_per_device
    while n <= len(devs):
        mesh = make_mesh(nband=n, nspace=1, devices=devs[:n])
        nband = nband_fixed if args.mode == "strong" else \
            n * args.nband_per_device
        rate = bench_mesh(mesh, nband, nx)
        results.append(dict(ndevices=n, nband=nband,
                            matvecs_per_s=round(rate, 3),
                            band_matvecs_per_s=round(rate * nband, 3)))
        n *= 2
    if args.mode == "strong":
        # fixed total work: ideal is flat wall time on shared cores
        base = results[0]["matvecs_per_s"]
        for r in results:
            r["efficiency"] = round(r["matvecs_per_s"] / base, 4)
    else:
        results = efficiency_table(results)
    if args.process_id in (None, 0):
        print(json.dumps({"metric": "matvec_scaling",
                          "platform": platform, "nx": nx,
                          "mode": args.mode,
                          "results": results}))


if __name__ == "__main__":
    main()
