"""Experiment layer (port of `repro.experiments`).

`ensemble` buckets instances by padded shape and solves the ordering LP
for each bucket in one batched solve on the device; `sweep` runs the
requested schemes over an ensemble through `repro_torch.pipeline` on top
of that shared LP phase; `results` persists flat rows as JSON + CSV.  The
fabric on top: `cache` is the content-addressed result store (cells keyed
by instance + scheme + config + code fingerprint; hits skip the pipeline,
the manifest survives restarts) and `runner` the sharded executor (each
worker builds its own shard's instances; `torch.distributed` behind the
single-process interface; rows gathered back into `results`).  `stream`
is `sweep`'s online sibling.
"""

from repro_torch.experiments.cache import SweepCache, code_fingerprint
from repro_torch.experiments.ensemble import (
    Bucket,
    bucket_shape,
    build_buckets,
    solve_ensemble_lp,
)
from repro_torch.experiments.results import (
    device_gather,
    group_mean,
    results_dir,
    save_json,
    save_rows,
    tail_columns,
)
from repro_torch.experiments.runner import (
    merge_shards,
    run_distributed,
    run_shard,
    shard_indices,
)
from repro_torch.experiments.sweep import (
    DEFAULT_SCHEMES,
    InstanceRecord,
    SweepResult,
    sweep,
)

# Imported last: repro_torch.streaming reads repro_torch.experiments.results.
from repro_torch.streaming import EpochRecord, StreamResult, stream  # noqa: E402

__all__ = [
    "Bucket",
    "bucket_shape",
    "build_buckets",
    "solve_ensemble_lp",
    "SweepCache",
    "code_fingerprint",
    "shard_indices",
    "run_shard",
    "run_distributed",
    "merge_shards",
    "device_gather",
    "group_mean",
    "results_dir",
    "save_json",
    "save_rows",
    "tail_columns",
    "DEFAULT_SCHEMES",
    "InstanceRecord",
    "SweepResult",
    "sweep",
    "EpochRecord",
    "StreamResult",
    "stream",
]
