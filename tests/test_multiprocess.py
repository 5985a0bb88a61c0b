"""Multi-PROCESS (multi-host analogue) smoke test: two separate
Python processes join through jax.distributed (the DCN path the
reference reaches with scheduler='distributed' + host_address,
pfb/__init__.py:81-104), build one global ('band', 'space') mesh over
their combined virtual CPU devices and run the band-sharded PSF
Hessian + psum'd power method — asserting both processes agree with a
single-process reference run."""

import os
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
from pfb_tpu.parallel.runtime import set_client
mesh = set_client(nband=4, precision="double", compile_cache=False,
                  coordinator="localhost:{port}", num_processes=2,
                  process_id=pid)
assert len(jax.devices()) == 4, jax.devices()

import numpy as np
import jax.numpy as jnp
from pfb_tpu.ops.fft import make_psfhat
from pfb_tpu.parallel.dist import hessian_psf_dist, power_method_dist
from pfb_tpu.parallel.mesh import band_sharding

nband, nx, ny = 4, 16, 16
nxp, nyp = 2 * nx, 2 * ny
x = np.arange(nxp) - nx
xx, yy = np.meshgrid(x, x, indexing="ij")
psf = np.zeros((nband, nxp, nyp))
for b in range(nband):
    s = 1.0 + 0.3 * b
    psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
    psf[b, nx, ny] += 0.5
psfhat = np.asarray(make_psfhat(jnp.asarray(psf)))
rng = np.random.default_rng(0)
xc = rng.normal(size=(nband, nx, ny))

sh = band_sharding(mesh)
xd = jax.make_array_from_callback(
    (nband, nx, ny), sh, lambda idx: xc[idx])
phd = jax.make_array_from_callback(
    psfhat.shape, sh, lambda idx: psfhat[idx])
hess = hessian_psf_dist(mesh, nyp)
out = hess(xd, phd)
# each process holds its shards; gather via process_allgather
from jax.experimental import multihost_utils
full = multihost_utils.process_allgather(out, tiled=True)
pm = power_method_dist(mesh, nyp, tol=1e-10, maxit=200)
beta, _ = pm(xd, phd)
np.savez(sys.argv[2], out=np.asarray(full), beta=float(beta))
print("proc", pid, "ok", flush=True)
"""


@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_two_process_mesh(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = WORKER.format(repo=repo, port=port)
    outs = [str(tmp_path / f"o{i}.npz") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), outs[i]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    logs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-2000:]

    # single-process reference
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp

    from pfb_tpu.ops.fft import make_psfhat
    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.opt.power_method import power_method

    nband, nx, ny = 4, 16, 16
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nx
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nx, ny] += 0.5
    psfhat = make_psfhat(jnp.asarray(psf))
    rng = np.random.default_rng(0)
    xc = rng.normal(size=(nband, nx, ny))
    ref = np.asarray(make_psf_convolve(psfhat, nyp)(jnp.asarray(xc)))
    beta_ref, _ = power_method(
        make_psf_convolve(psfhat, nyp), (nband, nx, ny), tol=1e-10,
        maxit=200, dtype=jnp.float64)

    for o in outs:
        d = np.load(o)
        np.testing.assert_allclose(d["out"], ref, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(d["beta"], float(beta_ref),
                                   rtol=1e-8)
