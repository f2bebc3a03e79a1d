"""Sharded sweep runner: partition cells across workers, gather rows (port
of `repro.experiments.runner`).

A sweep is declared as a list of **cell specs** -- small JSON-able dicts of
sweep coordinates (seed, K, N, ...) -- plus a ``make(spec)`` factory that
builds one `CoflowInstance`.  Each worker builds *only its shard's
instances*, runs the ordinary `sweep()` over them (content-cached with
``cache=``) and writes one shard artifact; `merge_shards` gathers the rows.

Three entry points, one sharding contract (shard i of n owns the i-th
contiguous slice of specs, `shard_indices`):

  * `run_shard`        -- explicit (shard, num_shards);
  * `run_distributed`  -- the shard from `torch.distributed`
    (`repro_torch.launch.mesh.init_distributed` / `process_shard`), a
    barrier, and the gather on rank 0; in one process it is shard 0 of 1
    plus the merge;
  * `merge_shards`     -- the gather alone, for shards run elsewhere on a
    shared results directory.

Every row carries its global ``cell`` index, and the gather rewrites
``instance`` to it, so the merged artifact equals one sweep's over the
whole spec list.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.experiments.cache import SweepCache
from repro_torch.experiments.results import results_dir, save_rows
from repro_torch.experiments.sweep import SweepResult, sweep

__all__ = [
    "shard_indices",
    "shard_name",
    "run_shard",
    "merge_shards",
    "run_distributed",
]


def shard_indices(n: int, shard: int, num_shards: int) -> list[int]:
    """Global indices owned by `shard` of `num_shards`: contiguous and
    balanced (sizes differ by at most one, as `numpy.array_split`)."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    base, extra = divmod(n, num_shards)
    start = shard * base + min(shard, extra)
    stop = start + base + (1 if shard < extra else 0)
    return list(range(start, stop))


def shard_name(name: str, shard: int, num_shards: int) -> str:
    """Artifact name of one shard's rows (sortable, self-describing)."""
    return f"{name}.shard{shard:04d}-of-{num_shards:04d}"


def run_shard(
    specs: Sequence[Mapping[str, Any]],
    make: Callable[[Mapping[str, Any]], Any],
    *,
    name: str | None = None,
    shard: int = 0,
    num_shards: int = 1,
    base: str = "ours",
    gc_max_bytes: int | None = None,
    gc_max_cells: int | None = None,
    device: str | torch.device = "cuda",
    **sweep_kwargs,
) -> SweepResult:
    """Build and sweep this shard's cells on ``device``; with ``name``,
    save its rows as ``<shard_name>.json/.csv`` for `merge_shards`.

    ``specs[i]`` becomes row metadata (plus ``cell=i``); ``make(specs[i])``
    is called only for this shard's indices.  Other keyword arguments go
    to `sweep` (``cache=`` makes re-runs resumable; a shared cache
    directory lets any worker reuse any worker's cells).
    ``gc_max_bytes`` / ``gc_max_cells`` LRU-evict the cache down to those
    budgets after the sweep's flush (`SweepCache.gc`); ignored without
    ``cache=``.
    """
    device = resolve_device(device)
    idx = shard_indices(len(specs), shard, num_shards)
    instances = [make(specs[i]) for i in idx]
    metas = [dict(specs[i], cell=i) for i in idx]
    cache = sweep_kwargs.get("cache")
    budgets = gc_max_bytes is not None or gc_max_cells is not None
    if isinstance(cache, str) and budgets:
        # One store object for the sweep and the gc after it.
        cache = SweepCache(cache)
        sweep_kwargs["cache"] = cache
    result = sweep(instances, metas=metas, device=device, **sweep_kwargs)
    if cache is not None and budgets:
        cache.gc(max_bytes=gc_max_bytes, max_cells=gc_max_cells)
    if name is not None:
        save_rows(shard_name(name, shard, num_shards), result.rows(base))
    return result


def merge_shards(name: str, num_shards: int, out: str | None = None) -> tuple[str, str]:
    """Concatenate the shard artifacts into one ``<name>.json/.csv`` pair,
    ordered by global cell id, ``instance`` rewritten to ``cell``."""
    rows: list[dict] = []
    for shard in range(num_shards):
        path = os.path.join(results_dir(), f"{shard_name(name, shard, num_shards)}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing shard artifact {path}; did shard {shard} run?")
        with open(path) as f:
            rows.extend(json.load(f))
    for row in rows:
        if "cell" in row:
            row["instance"] = row["cell"]
    rows.sort(key=lambda r: r.get("cell", 0))
    return save_rows(out or name, rows)


def run_distributed(
    specs: Sequence[Mapping[str, Any]],
    make: Callable[[Mapping[str, Any]], Any],
    *,
    name: str,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    base: str = "ours",
    device: str | torch.device = "cuda",
    **sweep_kwargs,
) -> SweepResult:
    """A multi-process sweep behind the single-process interface.

    Brings up `torch.distributed` (a no-op in one process), runs this
    process's shard through `run_shard`, waits at a barrier for every
    shard's artifact, and gathers the rows on rank 0.  Every process runs
    the same line, with ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK`` set (or the arguments passed).  Processes share the results
    directory (and the cache directory, if any).  With ``device="cuda"``
    and more than one process, each rank takes the card ``LOCAL_RANK``
    names (the rank modulo the host's cards without it).
    """
    from repro_torch.launch.mesh import init_distributed, process_shard

    device = resolve_device(device)
    multi = init_distributed(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    shard, num_shards = process_shard()
    if multi and device.type == "cuda" and device.index is None:
        # One card per rank on a multi-card host: torch's LOCAL_RANK, else
        # the rank modulo the host's cards.
        local = int(os.environ.get("LOCAL_RANK", shard)) % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    t0 = time.perf_counter()
    result = run_shard(
        specs, make, name=name, shard=shard, num_shards=num_shards, base=base,
        device=device, **sweep_kwargs,
    )
    if multi:
        # Every shard's artifact is written before rank 0 gathers them.
        torch.distributed.barrier()
    if shard == 0:
        merge_shards(name, num_shards)
    print(
        f"runner: shard {shard}/{num_shards} swept {len(result.records)} cells "
        f"in {time.perf_counter() - t0:.2f}s"
    )
    return result
