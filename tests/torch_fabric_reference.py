"""The JAX package's experiment fabric, loaded for the port's tests.

`repro.experiments` cannot be imported under the installed JAX (its
package imports `repro.pipeline`, which imports a name jax 0.9 dropped),
so the tests reach the reference this way, and nothing in the JAX
package changes:

* `experiments/ensemble.py`, `experiments/cache.py` and
  `pipeline/spec.py` load by file path (their own imports work);
* `sweep.py`'s and `runner.py`'s definitions are compiled from source with
  `ast`, their `repro.*` names bound to the port's CPU counterparts
  (pipelines, LP solvers, certificate, results), which the other
  `test_torch_*` files hold to the reference;
* `reference_imports()` gives the `sys.modules` entries the reference's
  lazy imports read (`repro.pipeline.spec` for `scheme_digest`,
  `repro.pipeline.refine` for `sweep(refine=)`, `repro.experiments.cache`
  for `run_shard`'s budgets), for a test to set with
  ``monkeypatch.setitem`` while it runs them.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import pathlib
import sys
import time
import types
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from repro_torch.core import lp, scheduler, theory
from repro_torch.core.coflow import CoflowInstance
from repro_torch.experiments import results
from repro_torch.experiments.ensemble import solve_ensemble_lp
from repro_torch.pipeline import PAPER_SCHEMES, get_pipeline
from repro_torch.pipeline import refine as port_refine

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, REF / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


REF_ENSEMBLE = _load("_reference_experiments_ensemble", "experiments/ensemble.py")
REF_CACHE = _load("_reference_experiments_cache", "experiments/cache.py")
REF_SPEC = _load("_reference_pipeline_spec", "pipeline/spec.py")


def reference_imports() -> dict:
    """`sys.modules` entries for the reference's lazy imports."""
    return {"repro.pipeline.spec": REF_SPEC, "repro.pipeline.refine": port_refine,
            "repro.experiments.cache": REF_CACHE}


class _CpuPipeline:
    """A port pipeline taking the reference's call signatures, on the CPU."""

    def __init__(self, pipe):
        self.pipe = pipe

    def run_batch(self, instances, lp_solutions=None, validate=True, stage_cache=None,
                  mesh=None, refine=None):
        assert mesh is None
        return self.pipe.run_batch(instances, lp_solutions=lp_solutions, validate=validate,
                                   stage_cache=stage_cache, refine=refine, device="cpu")

    def run(self, instance, lp_solution=None, validate=True, refine=None):
        return self.pipe.run(instance, lp_solution=lp_solution, validate=validate,
                             refine=refine, device="cpu")


def _cpu_ensemble_lp(instances, iters, m_quantum, p_quantum, mesh=None):
    assert mesh is None
    return solve_ensemble_lp(instances, iters=iters, m_quantum=m_quantum,
                             p_quantum=p_quantum, device="cpu")


def _compile(rel: str, names: set[str], namespace: dict, module_name: str):
    path = REF / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    defs = [n for n in tree.body if getattr(n, "name", None) in names
            or (isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) in names)]
    future = ast.ImportFrom(module="__future__", names=[ast.alias(name="annotations")], level=0)
    module = ast.fix_missing_locations(ast.Module(body=[future] + defs, type_ignores=[]))
    mod = types.ModuleType(module_name)
    sys.modules[mod.__name__] = mod
    mod.__dict__.update(namespace)
    exec(compile(module, str(path), "exec"), mod.__dict__)
    return mod


REF_SWEEP = _compile(
    "experiments/sweep.py",
    {"DEFAULT_SCHEMES", "InstanceRecord", "SweepResult", "_cell_payload", "sweep"},
    dict(
        np=np, dataclasses=dataclasses, time=time, Any=Any, Mapping=Mapping,
        Sequence=Sequence, CoflowInstance=CoflowInstance, scheduler=scheduler,
        theory=theory, cache_mod=REF_CACHE, save_rows=results.save_rows,
        tail_columns=results.tail_columns, solve_ensemble_lp=_cpu_ensemble_lp,
        pipeline_mod=types.SimpleNamespace(
            PAPER_SCHEMES=PAPER_SCHEMES,
            get_pipeline=lambda scheme, **kw: _CpuPipeline(get_pipeline(scheme, **kw)),
        ),
        lp=types.SimpleNamespace(
            solve_exact=lp.solve_exact,
            solve_subgradient=lambda inst, iters: lp.solve_subgradient(
                inst, iters=iters, device="cpu"),
        ),
    ),
    "_reference_compiled_sweep",
)

REF_RUNNER = _compile(
    "experiments/runner.py",
    {"shard_indices", "shard_name", "run_shard", "merge_shards"},
    dict(os=__import__("os"), time=time, Any=Any, Callable=Callable, Mapping=Mapping,
         Sequence=Sequence, results_dir=results.results_dir, save_rows=results.save_rows,
         SweepResult=REF_SWEEP.SweepResult, sweep=REF_SWEEP.sweep),
    "_reference_compiled_runner",
)
