"""The compile-cache helper and the graft entry's dry runs."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
from pfb_tpu.parallel.runtime import enable_compile_cache
d = enable_compile_cache()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.split()


def test_compile_cache_defaults_to_checkout():
    ret, cfg = _probe(None)
    assert ret == cfg == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    ret, cfg = _probe(str(tmp_path))
    assert ret == cfg == str(tmp_path)


def test_set_client_without_cache_leaves_config():
    import jax

    from pfb_tpu.parallel.runtime import set_client
    before = jax.config.jax_compilation_cache_dir
    mesh = set_client(nband=4, nspace=2, precision="double",
                      compile_cache=False)
    assert jax.config.jax_compilation_cache_dir == before
    assert (mesh.shape["band"], mesh.shape["space"]) == (4, 2)


def test_graft_entry_step():
    import jax
    sys.path.insert(0, REPO)
    from __graft_entry__ import entry
    fn, args = entry()
    model, dual = jax.jit(fn)(*args)
    assert model.shape == args[0].shape and dual.shape == args[1].shape


def test_graft_dryrun_multichip_four_devices():
    sys.path.insert(0, REPO)
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(4)


_BLOCKED = r"""
import sys
sys.path.insert(0, {repo!r})


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("sympy", "click", "yaml"):
            raise ImportError(f"blocked: {{name}}")


sys.meta_path.insert(0, Block())
import chip_smoke  # noqa: F401
from pfb_tpu.workers import grid, init, klean, restore, spotless  # noqa
from pfb_tpu.parallel import dist  # noqa: F401
print("ok")
"""


def test_main_path_needs_no_sympy_click_or_yaml():
    """init -> grid -> spotless/klean -> restore (and chip_smoke.py)
    import with sympy, click and PyYAML unavailable."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(repo=REPO)], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
