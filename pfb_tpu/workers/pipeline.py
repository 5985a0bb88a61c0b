"""Pipeline recipes: chain workers from a YAML file.

The reference integrates with stimela so each worker is callable from
recipe files (pfb/parser/uncabbedcabs.yml, pfb/stimela_cabs.yml). This
stack's equivalent is a self-contained recipe runner:

    # recipe.yaml
    steps:
      - worker: init
        params: {ms: obs.npz, output-filename: out,
                 channels-per-image: 1}
      - worker: grid
        params: {output-filename: out, field-of-view: 0.4,
                 robustness: 0.0}
      - worker: klean
        params: {output-filename: out, niter: 10}
      - worker: restore
        params: {output-filename: out}

    pfb-tpu pipeline recipe.yaml

Parameters use the schema names ('-' separated); unknown workers or
parameters raise before anything runs.
"""

import yaml

from pfb_tpu.parser.schemas import defaults_for, schema

_WORKERS = {
    "init": ("pfb_tpu.workers.init", "_init"),
    "grid": ("pfb_tpu.workers.grid", "_grid"),
    "klean": ("pfb_tpu.workers.klean", "_klean"),
    "spotless": ("pfb_tpu.workers.spotless", "_spotless"),
    "fwdbwd": ("pfb_tpu.workers.fwdbwd", "_fwdbwd"),
    "fluxmop": ("pfb_tpu.workers.fluxmop", "_fluxmop"),
    "model2comps": ("pfb_tpu.workers.model2comps", "_model2comps"),
    "degrid": ("pfb_tpu.workers.degrid", "_degrid"),
    "restore": ("pfb_tpu.workers.restore", "_restore"),
    "fastim": ("pfb_tpu.workers.fastim", "_fastim"),
    "smoovie": ("pfb_tpu.workers.smoovie", "_smoovie"),
}


def load_recipe(path):
    with open(path) as f:
        recipe = yaml.safe_load(f)
    steps = recipe.get("steps", [])
    # validate before running anything
    for i, step in enumerate(steps):
        worker = step.get("worker")
        if worker not in _WORKERS:
            raise ValueError(
                f"step {i}: unknown worker {worker!r}; "
                f"known: {sorted(_WORKERS)}")
        spec = getattr(schema, worker, None)
        known = {k.replace("-", "_")
                 for k in (spec or {}).get("inputs", {})}
        for key in step.get("params", {}):
            if known and key.replace("-", "_") not in known:
                raise ValueError(
                    f"step {i} ({worker}): unknown parameter {key!r}")
    return steps


def run_recipe(path, verbose=1):
    """Execute a recipe; returns the list of per-step results."""
    import importlib

    steps = load_recipe(path)
    results = []
    for i, step in enumerate(steps):
        worker = step["worker"]
        params = {k.replace("-", "_"): v
                  for k, v in step.get("params", {}).items()}
        args = defaults_for(worker)
        args.update(params)
        mod_name, fn_name = _WORKERS[worker]
        fn = getattr(importlib.import_module(mod_name), fn_name)
        if verbose:
            from pfb_tpu.utils.logging import get_logger
            get_logger("PIPELINE").info(
                f"step {i + 1}/{len(steps)}: {worker}")
        results.append(fn(**args))
    return results
