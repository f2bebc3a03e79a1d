"""Stage-based scheduling pipeline (port of `repro.pipeline`: the five paper
schemes and EPS).

  * `repro_torch.pipeline.spec` -- `SchemeSpec` and the scheme registry;
  * `repro_torch.pipeline.stages` -- the order / allocate / circuit stages
    (list calendars batched on the device; sequential, BvN and fluid
    calendars per instance on the host);
  * `repro_torch.pipeline.pipeline` -- `Pipeline.run_batch`;
  * `repro_torch.pipeline.ensemble_batch` -- the padded `EnsembleBatch`
    built once per ensemble, and the `AllocationBatch` it produces;
  * `repro_torch.pipeline.batch_alloc` / `batch_circuit` -- the device
    allocation scan and the circuit calendars (pair space,
    ``circuit_engine="kernel"``; flow space, ``circuit_engine="jax"``).

Typical use::

    from repro_torch import pipeline
    from repro_torch.experiments import solve_ensemble_lp

    sols = solve_ensemble_lp(ens)                       # on the GPU
    results = pipeline.get_pipeline("ours").run_batch(ens, lp_solutions=sols)
"""

from repro_torch.core.scheduler import ScheduleResult, tail_cct, total_weighted_cct
from repro_torch.pipeline.ensemble_batch import (
    AllocationBatch,
    EnsembleBatch,
    build_ensemble_batch,
)
from repro_torch.pipeline.pipeline import Pipeline, build_pipeline, get_pipeline
from repro_torch.pipeline.spec import (
    PAPER_SCHEMES,
    SchemeSpec,
    get_scheme,
    list_schemes,
    register_scheme,
)

__all__ = [
    "ScheduleResult",
    "total_weighted_cct",
    "tail_cct",
    "AllocationBatch",
    "EnsembleBatch",
    "build_ensemble_batch",
    "Pipeline",
    "build_pipeline",
    "get_pipeline",
    "PAPER_SCHEMES",
    "SchemeSpec",
    "get_scheme",
    "list_schemes",
    "register_scheme",
]
