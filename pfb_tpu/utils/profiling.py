"""Profiling hooks.

The reference wraps dask.compute in a distributed performance_report
per worker invocation (compute_context, pfb/utils/misc.py:52-60). The
JAX equivalents: a jax.profiler trace context producing one trace per
worker run, and wall-clock phase timers.
"""

import contextlib
import time


def start_profile(profile_dir, name="pfb"):
    """Start a jax.profiler trace for the rest of the process (one
    trace per worker invocation — the reference's per-run
    performance_report convention). Wired to the CLI's
    ``--profile-dir`` flag; stopped at interpreter exit."""
    import atexit

    import jax
    jax.profiler.start_trace(f"{profile_dir}/{name}")

    def _stop():
        try:
            jax.profiler.stop_trace()
        except Exception:
            pass  # already stopped explicitly

    atexit.register(_stop)


@contextlib.contextmanager
def compute_context(profile_dir=None, name="pfb"):
    """Optional jax.profiler trace around a worker phase."""
    if profile_dir:
        import jax
        with jax.profiler.trace(f"{profile_dir}/{name}"):
            yield
    else:
        yield


class PhaseTimer:
    """Accumulating wall timers keyed by phase name."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, phase, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                import jax.numpy as jnp
                float(jnp.sum(sync_value))
            self.times[phase] = self.times.get(phase, 0.0) + \
                time.perf_counter() - t0

    def report(self):
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))
