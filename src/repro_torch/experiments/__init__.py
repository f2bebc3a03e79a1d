"""Experiment layer (port of `repro.experiments`): the bucketed ensemble
LP entry point, result persistence, and `stream()`, `sweep()`'s online
sibling.  Sweeps, caching and the runner are not ported yet."""

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
from repro_torch.streaming import EpochRecord, StreamResult, stream

__all__ = [
    "Bucket",
    "bucket_shape",
    "build_buckets",
    "solve_ensemble_lp",
    "device_gather",
    "group_mean",
    "results_dir",
    "save_json",
    "save_rows",
    "tail_columns",
    "EpochRecord",
    "StreamResult",
    "stream",
]
