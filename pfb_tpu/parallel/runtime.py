"""Runtime/device setup — the reference's set_client analogue.

The reference's set_client (pfb/__init__.py:36-124) does thread-budget
arithmetic and builds a dask LocalCluster or connects to a remote
scheduler. Here it configures JAX: persistent compilation cache,
optional multi-host initialisation (jax.distributed), precision, and
returns the global mesh.
"""

import os
from pathlib import Path

import jax

# the checkout root: pfb_tpu/parallel/runtime.py -> <checkout>
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its
    directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory (JAX
    reads the variable itself; no other directory is set in code).
    Otherwise the cache lives at the fixed ``<checkout>/.jax_cache``:
    the path is part of the cache key, so it must not move between
    runs."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(CHECKOUT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir


def set_client(nband=None, nspace=1, precision="single",
               compile_cache=True, coordinator=None,
               num_processes=None, process_id=None):
    """Initialise the runtime and return the device mesh.

    - single host: mesh over the local devices
    - multi host: jax.distributed.initialize first (coordinator address
      + process counts), then a global mesh over all devices — the SPMD
    replacement for the reference's LocalCluster / remote scheduler
    (scheduler='distributed', host_address).
    """
    if compile_cache:
        enable_compile_cache()
    if precision == "double":
        jax.config.update("jax_enable_x64", True)

    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)

    from pfb_tpu.parallel.mesh import make_mesh
    n = len(jax.devices())
    if nband is None:
        nband = n // nspace
    return make_mesh(nband=nband, nspace=nspace)
