"""Space-sharded PSF-Hessian matvec at flagship scale on the virtual
mesh: times hessian_psf_space_dist (distributed-rFFT2, two all_to_all
transposes) at 4096^2 x nband over 1..nspace shards and reports the
per-matvec wall time plus the analytic all_to_all volume per device —
the characterisation BASELINE.json's config 5 needs before a real pod
run (VERDICT r2 item 10). On a shared-core CPU host the absolute
times only validate the program; the communicated-bytes column is the
hardware-independent quantity.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/bench_space_shard.py [--nx 4096] [--nband 2]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# a virtual-device mesh on the host CPU
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--nband", type=int, default=2)
    ap.add_argument("--nrep", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from pfb_tpu.parallel.dist import (hessian_psf_space_dist,
                                       prep_psfhat_space)
    from pfb_tpu.parallel.mesh import make_mesh

    nx = args.nx
    nband = args.nband
    nxp = 2 * nx
    ndev = len(jax.devices())
    print(f"devices: {ndev}, cube {nband}x{nx}x{nx} f32 "
          f"({nband*nx*nx*4/1e9:.2f} GB)", flush=True)

    rng = np.random.default_rng(0)
    x_host = rng.normal(size=(nband, nx, nx)).astype(np.float32)
    # analytic PSFHAT (Gaussian) avoids a host-side 8192^2 FFT
    kx = np.fft.fftfreq(nxp)[None, :, None]
    ky = np.fft.rfftfreq(nxp)[None, None, :]
    ph_host = np.exp(-2e3 * (kx**2 + ky**2)).astype(np.complex64)
    ph_host = np.broadcast_to(ph_host, (nband, nxp, nxp // 2 + 1))

    rows = []
    for nspace in (1, 2, 4, 8):
        if nspace > ndev // max(1, nband) and nband * nspace > ndev:
            continue
        if nx % nspace:
            continue
        mesh = make_mesh(nband=nband, nspace=nspace,
                         devices=jax.devices()[:nband * nspace])
        hd = hessian_psf_space_dist(mesh, nxp, method="fft")
        from jax.sharding import NamedSharding, PartitionSpec as P
        xs = jax.device_put(jnp.asarray(x_host), NamedSharding(
            mesh, P("band", "space", None)))
        php = prep_psfhat_space(jnp.asarray(ph_host), nspace)
        php = jax.device_put(php, NamedSharding(
            mesh, P("band", None, "space")))
        out = hd(xs, php)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.nrep):
            out = hd(xs, php)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.nrep
        # per-device all_to_all payload: each transpose sends every
        # OTHER device a (nbl, nx/ns, nyw_l) complex64 piece of the
        # local (nbl, nx/ns, nyw_l*ns) spectrum block; two transposes
        # per matvec; rx == tx, so exchanged = 2 x sent
        nbl = nband // mesh.shape["band"]
        nyw_l = prep_psfhat_space(jnp.zeros((1, 1, nxp // 2 + 1)),
                                  nspace).shape[-1] // nspace
        sent = 2 * nbl * (nx // nspace) * nyw_l * (nspace - 1) * 8
        vol = 2 * sent  # tx + rx
        rows.append((nspace, dt, vol / 1e9))
        print(f"nspace={nspace}: {dt*1e3:8.1f} ms/matvec, "
              f"all_to_all {vol/1e9:6.2f} GB/device/matvec (tx+rx)",
              flush=True)

    print("\n| nspace | ms/matvec | all_to_all tx+rx GB/dev |")
    print("|---|---|---|")
    for ns, dt, gb in rows:
        print(f"| {ns} | {dt*1e3:.1f} | {gb:.2f} |")


if __name__ == "__main__":
    main()
