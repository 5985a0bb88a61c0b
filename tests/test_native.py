"""Native (C++) uv counts == the numpy counts, and the build's
fallbacks."""

import os

import numpy as np
import pytest

import pfb_tpu.native as native
from pfb_tpu.ops.weighting import compute_counts_host


def _geometry(nrow, nchan, nx, seed):
    rng = np.random.default_rng(seed)
    uvw = rng.normal(scale=nx, size=(nrow, 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    cell = 1.0 / (2 * umax * 2.0)
    mask = (rng.random((nrow, nchan)) > 0.1).astype(np.float64)
    return uvw, freq, cell, mask


@pytest.mark.parametrize("nrow,nchan,nx",
                         [(2000, 3, 128), (5000, 2, 300), (3000, 1, 64)])
def test_native_counts_match_numpy(monkeypatch, nrow, nchan, nx):
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    uvw, freq, cell, mask = _geometry(nrow, nchan, nx, nx)
    got = native.pg_counts_native(uvw, freq, mask, nx, nx, cell, cell)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    ref = compute_counts_host(uvw, freq, mask, nx, nx, cell, cell)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_native_counts_refuse_wide_stencil():
    """The C++ kernel's tap buffer holds 16 taps: a wider stencil
    returns None (numpy fallback) instead of writing out of bounds."""
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    uvw, freq, cell, mask = _geometry(100, 1, 32, 0)
    assert native.pg_counts_native(uvw, freq, mask, 32, 32, cell, cell,
                                   k=18) is None


def test_native_build_lands_in_checkout(monkeypatch):
    """Without PFB_TPU_NATIVE_CACHE the library is built under the
    checkout's .native_build directory, never outside it."""
    monkeypatch.delenv("PFB_TPU_NATIVE_CACHE", raising=False)
    path = native._build_lib()
    if path is None:
        pytest.skip("no C++ toolchain")
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(
        native.__file__)))
    assert os.path.dirname(path) == os.path.join(checkout,
                                                 ".native_build")
