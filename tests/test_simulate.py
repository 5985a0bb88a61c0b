"""simulate_ms evaluates its point-source model directly (nsource x
nvis, float64 on the host); that must be the image DFT of the model
cube it returns."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfb_tpu.ops.dft import dirty2vis_dft
from pfb_tpu.utils.ms import point_source_vis, read_ms, simulate_ms
from pfb_tpu.utils.simulation import image_size_for, simulate_obs


@pytest.mark.parametrize("fullpol", [False, True])
def test_simulate_ms_equals_image_dft(tmp_path, fullpol):
    ms = str(tmp_path / "s.npz")
    model, Ix, Iy, nx, cell, _ = simulate_ms(
        ms, nant=5, ntime=3, nchan=2, nsource=3, fov_deg=0.3, seed=8,
        gains=False, fullpol=fullpol)
    obs = simulate_obs(nant=5, ntime=3, nchan=2, seed=8)
    data = read_ms(ms)["DATA"]
    stokes = model if fullpol else model[None]
    dft = np.stack([np.stack([np.asarray(dirty2vis_dft(
        jnp.asarray(obs.uvw), jnp.asarray(obs.freq[c:c + 1]),
        jnp.asarray(cube[c]), cell, cell))[:, 0]
        for c in range(obs.freq.size)], axis=1) for cube in stokes])
    if fullpol:
        vI, vQ, vU, vV = dft
        ref = np.stack([vI + vQ, vU + 1j * vV, vU - 1j * vV, vI - vQ],
                       axis=-1)
    else:
        ref = np.stack([dft[0], dft[0]], axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(data - ref).max() / scale < 1e-10


def test_point_source_vis_skips_empty_channels():
    obs = simulate_obs(nant=4, ntime=2, nchan=3, seed=2)
    nx, cell = image_size_for(obs, fov_deg=0.2)
    cube = np.zeros((3, nx, nx))
    cube[1, nx // 2 + 3, nx // 2 - 2] = 2.0
    vis = point_source_vis(obs.uvw, obs.freq, cube, cell)
    assert np.all(vis[:, 0] == 0) and np.all(vis[:, 2] == 0)
    assert np.allclose(np.abs(vis[:, 1]), 2.0)
