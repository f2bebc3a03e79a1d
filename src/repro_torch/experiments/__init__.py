"""Experiment layer (port of `repro.experiments`): the bucketed ensemble
LP entry point.  Sweeps, caching and the runner are not ported yet."""

from repro_torch.experiments.ensemble import (
    Bucket,
    bucket_shape,
    build_buckets,
    solve_ensemble_lp,
)

__all__ = ["Bucket", "bucket_shape", "build_buckets", "solve_ensemble_lp"]
