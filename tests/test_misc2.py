"""Coverage for restoration helpers, island removal and give_edges."""

import numpy as np
from numpy.testing import assert_allclose


def test_restore_image_recovers_smooth_source():
    from pfb_tpu.utils.misc import Gaussian2D
    from pfb_tpu.utils.restoration import restore_image
    nband, nx = 2, 64
    x = np.arange(-(nx // 2), nx - nx // 2)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf_mfs = Gaussian2D(xx, yy, (3.0, 3.0, 0.0), normalise=False)
    model = np.zeros((nband, nx, nx))
    model[:, 32, 32] = 2.0
    residual = np.zeros_like(model)
    out = restore_image(model, residual, psf_mfs=psf_mfs)
    # peak of the restored image equals the model flux (unit-peak beam)
    assert_allclose(out[:, 32, 32], 2.0, rtol=1e-3)
    assert out[0, 30, 32] > 0.5  # smeared by the clean beam


def test_remove_large_islands():
    from pfb_tpu.utils.misc import remove_large_islands
    x = np.zeros((32, 32))
    x[2:4, 2:4] = 1.0          # small island (4 px)
    x[10:30, 10:30] = 1.0      # large island (400 px)
    out = remove_large_islands(x.copy(), max_island_size=100)
    assert out[2, 2] == 1.0
    assert out[20, 20] == 0.0


def test_give_edges_overlap():
    from pfb_tpu.utils.misc import give_edges
    ix, iy, ipx, ipy = give_edges(0, 0, 64, 64, 128, 128)
    # PSF centred at the image corner: image slice starts at 0 and the
    # psf slice is the lower-right quadrant
    assert ix == slice(0, 64) and iy == slice(0, 64)
    assert ipx == slice(64, 128) and ipy == slice(64, 128)
