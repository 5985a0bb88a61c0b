"""Global precision configuration.

The reference defaults to float64 everywhere (pfb/__init__.py:59 sets
JAX_ENABLE_X64; init.yaml precision: double). The policy here:

- CPU (tests, parity checks): enable x64 and compute in float64.
- GPU: compute in float32, which halves the bytes of every
  bandwidth-bound pass (the FFT convolve, the gridder's grid stack)
  and keeps the single-card 4096^2 x 8 deployment within device
  memory; float64 (or compensated) accumulation where the reference
  uses double_precision_accumulation. Matrix products that feed an
  exact result ask for ``Precision.HIGHEST``: a float32 product at
  DEFAULT precision may run in TF32 on the GPU.

Every op takes its dtype from its inputs; this module only provides the
*default* dtypes used when workers allocate fresh arrays.
"""

import jax
import jax.numpy as jnp

_PRECISION = "double" if jax.config.jax_enable_x64 else "single"


def set_precision(precision: str):
    """Set default precision: 'single' or 'double'.

    'double' requires jax_enable_x64 (enabled automatically).
    """
    global _PRECISION
    if precision not in ("single", "double"):
        raise ValueError(f"Unknown precision {precision}")
    if precision == "double":
        jax.config.update("jax_enable_x64", True)
    _PRECISION = precision


def default_real_dtype():
    return jnp.float64 if _PRECISION == "double" else jnp.float32


def default_complex_dtype():
    return jnp.complex128 if _PRECISION == "double" else jnp.complex64


def complex_for(real_dtype):
    """Complex dtype matching a real dtype."""
    return jnp.result_type(real_dtype, jnp.complex64)
