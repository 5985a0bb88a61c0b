"""chip_smoke.py off the card: it refuses to run without a GPU (also
as a lone file), and its single-card and four-card pipelines run end
to end at a tiny size on the CPU (8 virtual devices, float64)."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(chip_smoke.DEPLOYMENT, nant=6, ntime=4, nchan=4, nsource=2,
            extent=1000.0, nx=64, niter=1, pd_maxit=20, bases="self,db1",
            nlevels=2)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _prints_no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_chip_smoke_refuses_cpu():
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert _prints_no_result(proc)
    assert "needs a GPU" in proc.stderr


def test_bench_refuses_cpu():
    proc = _run(os.path.join(REPO, "bench.py"), REPO)
    assert proc.returncode != 0
    assert _prints_no_result(proc)
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run("chip_smoke.py", str(tmp_path))
    assert proc.returncode != 0
    assert _prints_no_result(proc)


def test_chip_smoke_single_card_pipeline_tiny(tmp_path):
    ph = chip_smoke.Phases()
    err = chip_smoke.run_single(dict(TINY), str(tmp_path), ph,
                                run_tests=False)
    assert err <= 1e-4
    names = [r[0] for r in ph.rows]
    assert names == ["simulate", "init+grid", "spotless", "klean",
                     "restore", "regrid model"]


def test_chip_smoke_four_card_pipeline_tiny(tmp_path):
    ph = chip_smoke.Phases()
    res = chip_smoke.run_four_cards(dict(TINY, niter=2), str(tmp_path),
                                    ph)
    assert set(res) == {"exact residual", "model niter=1"}
    assert max(res.values()) <= chip_smoke.FOUR_CARD_GATE
    names = [r[0] for r in ph.rows]
    assert "spotless_dist niter=2, 4 cards" in names


def test_ulp_perturbed_moves_every_pixel_one_ulp():
    import numpy as np
    x = np.random.default_rng(3).normal(size=(16, 16)).astype(np.float32)
    ds = [{"DIRTY": x, "bandid": 0}]
    y = chip_smoke.ulp_perturbed(ds)[0]["DIRTY"]
    assert ds[0]["DIRTY"] is x and y.dtype == x.dtype
    step = np.abs(y.astype(np.float64) - x) / np.spacing(np.abs(x))
    assert np.all((step >= 0.5) & (step <= 1.0))
    assert 0 < np.sum(y > x) < x.size


def test_chip_smoke_deployment_is_the_issue_size():
    d = chip_smoke.DEPLOYMENT
    assert (d["nant"], d["ntime"], d["nchan"], d["nx"]) == \
        (64, 500, 8, 4096)
    assert d["epsilon"] == 1e-5 and d["bases"] == "self,db1,db2"
    assert d["backend"] == "wgrid"
    assert json.loads(json.dumps(d)) == d
