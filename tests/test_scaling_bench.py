"""Scaling-efficiency harness (scripts/scaling_bench.py): shape and
semantics regression so the recorded BASELINE.md tables stay
reproducible."""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.scaling_bench import bench_mesh, efficiency_table
from pfb_tpu.parallel.mesh import make_mesh


def test_bench_mesh_rates_positive():
    mesh1 = make_mesh(nband=1, nspace=1, devices=jax.devices()[:1])
    mesh2 = make_mesh(nband=2, nspace=1, devices=jax.devices()[:2])
    r1 = bench_mesh(mesh1, 1, 32, reps=1, chain=2)
    r2 = bench_mesh(mesh2, 2, 32, reps=1, chain=2)
    assert r1 > 0 and r2 > 0


def test_bench_mesh_band_sharded_four_devices():
    """The harness on a 4-device band mesh (2 bands per device)."""
    mesh4 = make_mesh(nband=4, nspace=1, devices=jax.devices()[:4])
    assert bench_mesh(mesh4, 8, 32, reps=1, chain=1) > 0


def test_efficiency_table_shape():
    results = [
        dict(ndevices=1, nband=1, matvecs_per_s=10.0,
             band_matvecs_per_s=10.0),
        dict(ndevices=2, nband=2, matvecs_per_s=9.0,
             band_matvecs_per_s=18.0),
        dict(ndevices=4, nband=4, matvecs_per_s=8.0,
             band_matvecs_per_s=32.0),
    ]
    out = efficiency_table(results)
    assert [r["efficiency"] for r in out] == [1.0, 0.9, 0.8]
    for r in out:
        assert set(r) == {"ndevices", "nband", "matvecs_per_s",
                          "band_matvecs_per_s", "efficiency"}
