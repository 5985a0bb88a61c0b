"""pfb-tpu CLI.

Equivalent of the reference console script (pfb/workers/main.py:1-13 +
scabha clickify): one click group with a sub-command per worker, options
generated from the YAML schemas in pfb_tpu/parser/.
"""

import click

from pfb_tpu.parser.schemas import defaults_for, schema

_DTYPES = {"str": str, "int": int, "float": float, "bool": bool}


def _clickify(worker):
    """Decorate a command with options from the worker's schema."""
    spec = getattr(schema, worker)

    def deco(fn):
        for key, field in reversed(list(spec.get("inputs", {}).items())):
            opt = f"--{key}"
            names = [opt]
            if field.get("abbreviation"):
                names.append(f"-{field['abbreviation']}")
            dtype = _DTYPES.get(field.get("dtype", "str"), str)
            if dtype is bool:
                fn = click.option(opt + "/--no-" + key,
                                  default=field.get("default", False),
                                  help=field.get("info", ""))(fn)
            else:
                fn = click.option(*names, type=dtype,
                                  default=field.get("default"),
                                  required=field.get("required", False),
                                  show_default=True,
                                  help=field.get("info", ""))(fn)
        return fn

    return deco


@click.group()
@click.option("--profile-dir", default=None,
              help="Write a jax.profiler trace for this worker run "
                   "under DIR (one trace per invocation, the analogue "
                   "of the reference's dask performance_report).")
@click.option("--coordinator", default=None,
              help="jax.distributed coordinator address host:port for "
                   "multi-host runs (the analogue of the reference's "
                   "--host-address dask scheduler option).")
@click.option("--num-processes", type=int, default=None,
              help="Total process count of the multi-host run "
                   "(reference --nworkers analogue).")
@click.option("--process-id", type=int, default=None,
              help="This process's index in the multi-host run.")
def cli(profile_dir, coordinator, num_processes, process_id):
    """pfb-tpu: JAX radio-interferometric imaging suite."""
    if profile_dir:
        from pfb_tpu.utils.profiling import start_profile
        start_profile(profile_dir)
    if coordinator:
        from pfb_tpu.parallel.runtime import set_client
        set_client(coordinator=coordinator,
                   num_processes=num_processes, process_id=process_id)


def _args(worker, kw):
    """Schema defaults overlaid with the CLI's non-None options; pops
    log-directory and attaches the per-run file log there (reference:
    pyscilog.log_to_file into opts.log_directory)."""
    import os
    import time as _time

    args = defaults_for(worker)
    args.update({k: v for k, v in kw.items() if v is not None})
    ldir = args.pop("log_directory", None)
    if ldir:
        os.makedirs(ldir, exist_ok=True)
        from pfb_tpu.utils.logging import log_to_file
        stamp = _time.strftime("%Y%m%d-%H%M%S")
        log_to_file(os.path.join(ldir, f"{worker}_{stamp}.log"))
    return args


@cli.command()
@_clickify("init")
def init(**kw):
    """Create a Stokes visibility store from an MS."""
    from pfb_tpu.workers.init import _init
    _init(write=True, **_args("init", kw))


@cli.command()
@_clickify("grid")
def grid(**kw):
    """Grid visibilities to dirty/PSF image products."""
    from pfb_tpu.workers.grid import _grid
    args = _args("grid", kw)
    args["filter_extreme_counts_flag"] = args.pop(
        "filter_extreme_counts", False)
    _grid(write=True, **args)


@cli.command()
@_clickify("klean")
def klean(**kw):
    """Modified single-scale CLEAN."""
    from pfb_tpu.workers.klean import _klean
    args = _args("klean", kw)
    _klean(write=True, **args)


@cli.command()
@_clickify("spotless")
def spotless(**kw):
    """SARA wavelet-sparsity deconvolution."""
    from pfb_tpu.workers.spotless import _spotless
    args = _args("spotless", kw)
    _spotless(write=True, **args)


@cli.command()
@_clickify("model2comps")
def model2comps(**kw):
    """Fit the model cube to a continuous parametrisation."""
    from pfb_tpu.workers.model2comps import _model2comps
    args = _args("model2comps", kw)
    _model2comps(**args)


@cli.command()
@_clickify("degrid")
def degrid(**kw):
    """Render the component model to model visibilities."""
    from pfb_tpu.workers.degrid import _degrid
    args = _args("degrid", kw)
    _degrid(write=True, **args)


@cli.command()
@_clickify("restore")
def restore(**kw):
    """Write restored FITS image products."""
    from pfb_tpu.workers.restore import _restore
    args = _args("restore", kw)
    _restore(**args)


@cli.command()
@_clickify("fluxmop")
def fluxmop(**kw):
    """Standalone forward (PCG) step."""
    from pfb_tpu.workers.fluxmop import _fluxmop
    args = _args("fluxmop", kw)
    _fluxmop(write=True, **args)


@cli.command()
@_clickify("fastim")
def fastim(**kw):
    """High-cadence residual snapshot imaging."""
    from pfb_tpu.workers.fastim import _fastim
    args = _args("fastim", kw)
    args["filter_extreme_counts_flag"] = args.pop(
        "filter_extreme_counts", False)
    _fastim(write=True, **args)


@cli.command()
@_clickify("smoovie")
def smoovie(**kw):
    """Render fds snapshots to a movie."""
    from pfb_tpu.workers.smoovie import _smoovie
    args = _args("smoovie", kw)
    _smoovie(write=True, **args)


@cli.command()
@_clickify("fwdbwd")
def fwdbwd(**kw):
    """Generalised forward-backward with nonlinear parametrisation."""
    from pfb_tpu.workers.fwdbwd import _fwdbwd
    args = _args("fwdbwd", kw)
    _fwdbwd(write=True, **args)


@cli.command()
@click.argument("recipe", type=click.Path(exists=True))
def pipeline(recipe):
    """Run a YAML pipeline recipe (chained workers)."""
    from pfb_tpu.workers.pipeline import run_recipe
    run_recipe(recipe)


if __name__ == "__main__":
    cli()
