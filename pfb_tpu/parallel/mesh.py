"""Mesh and sharding helpers."""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(nband=None, nspace=1, devices=None):
    """Mesh with ('band', 'space') axes.

    The band axis carries the embarrassingly parallel frequency
    decomposition (the reference's one-dataset-per-band actors,
    workers/spotless.py:516-524); the space axis shards the image plane
    for grids that exceed one device's memory (SURVEY.md section 5
    "long-context analogue").
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if nband is None:
        nband = n // nspace
    assert nband * nspace == n, \
        f"{nband} x {nspace} != {n} devices"
    dev = np.asarray(devices).reshape(nband, nspace)
    return Mesh(dev, ("band", "space"))


def band_sharding(mesh, space_axis=None):
    """Sharding for (nband, nx, ny) cubes: band axis over 'band',
    optionally nx over 'space'."""
    return NamedSharding(mesh, P("band", space_axis, None))


def coeff_sharding(mesh):
    """Sharding for (nband, nbasis, Nymax, Nxmax) dual/coefficient
    cubes."""
    return NamedSharding(mesh, P("band", None, None, None))


def replicated(mesh):
    return NamedSharding(mesh, P())
