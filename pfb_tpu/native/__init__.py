"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; the host-side runtime around it — here
the uv-counts pass of Briggs weighting, the role numba plays for the
reference's host side — is native C++ compiled on first use with the
system toolchain and cached. Every native routine has a numpy
fallback, so the package works without a compiler.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_here = os.path.dirname(__file__)
_lib = None
_lib_tried = False


def _build_lib():
    """Compile plan.cc to a cached shared library; returns its path or
    None when no toolchain is available."""
    src = os.path.join(_here, "plan.cc")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get(
        "PFB_TPU_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(_here)),
                     ".native_build"))
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, f"plan_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
            "-o", tmp]
    for cmd in (base + ["-fopenmp"], base):  # OpenMP when available
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
            return out
        except (subprocess.CalledProcessError, FileNotFoundError,
                OSError):
            continue
    return None


def get_lib():
    """The loaded native library, or None (numpy fallback)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("PFB_TPU_NO_NATIVE"):
        return None
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    dbl = ctypes.c_double
    p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pg_compute_counts.argtypes = [
        p_dbl, i64, p_dbl, i64, p_u8, i64, i64, dbl, dbl,
        ctypes.c_int, p_dbl]
    lib.pg_compute_counts.restype = ctypes.c_int
    _lib = lib
    return _lib


def pg_counts_native(uvw, freq, mask, nx, ny, cellx, celly, k=6):
    """Native ES-stencil uv counts (the reference's numba
    _compute_counts as C++; pfb/utils/weighting.py:43-103), or None
    when no native library is available. Identical per-tap drop
    semantics to ops.weighting.compute_counts."""
    lib = get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    freq = np.ascontiguousarray(freq, np.float64)
    mask = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    out = np.zeros(int(nx) * int(ny), np.float64)
    rc = lib.pg_compute_counts(uvw, uvw.shape[0], freq, freq.shape[0],
                               mask, int(nx), int(ny), float(cellx),
                               float(celly), int(k), out)
    if rc != 0:
        return None
    return out.reshape(int(nx), int(ny))
