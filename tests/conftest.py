"""Test configuration.

Tests run on CPU in float64 for parity with the reference test suite
(which asserts identities at 1e-8..1e-12 in double precision, see
/root/reference/tests). Multi-device tests use 8 virtual CPU devices via
XLA_FLAGS, mirroring how the reference's distributed paths *should* have
been tested (SURVEY.md section 4).

Tests that need the GPU carry the ``chip`` marker and the ``gpu``
fixture, which skips them where JAX finds no GPU. ``pytest -m chip
tests/test_chip.py`` on the card (or chip_smoke.py, which runs them in
its own process) keeps the session's GPU platform and float32; every
other selection is forced onto the CPU in float64 before any test
module imports JAX.
"""

import os

import pytest


def _chip_only(config):
    expr = (config.getoption("markexpr", "") or "").replace(" ", "")
    return expr == "chip"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: end-to-end pipelines dominating suite wall time — "
        "skip with `-m 'not slow'` for a fast iteration loop "
        "(release gates run everything)")
    config.addinivalue_line(
        "markers",
        "chip: needs the GPU; skipped (by the gpu fixture) without one")
    if _chip_only(config):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "true")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
