"""Result aggregation and JSON/CSV persistence (port of
`repro.experiments.results`).

Every sweep produces flat row dicts; `save_rows` writes the same rows as
both ``<name>.json`` and ``<name>.csv`` under the results directory
(``REPRO_RESULTS`` env var, default ``results/benchmarks``) so figure
scripts and spreadsheets read one artifact.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.scheduler import tail_cct
from repro_torch.tree import map_leaves

__all__ = [
    "results_dir",
    "save_rows",
    "save_json",
    "group_mean",
    "tail_columns",
    "device_gather",
]


def device_gather(tree):
    """Every tensor of a nested dict / list tree as host NumPy.

    The step that brings a batch computed on the card (an
    `LPSolutionBatch`'s fields, say) to the host for unpadding and export.
    Leaves that are not tensors pass through untouched.
    """
    return map_leaves(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree
    )


def results_dir() -> str:
    return os.environ.get("REPRO_RESULTS", "results/benchmarks")


def save_json(name: str, payload: Any) -> str:
    """Write one JSON artifact; returns its path."""
    os.makedirs(results_dir(), exist_ok=True)
    path = os.path.join(results_dir(), f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def save_rows(
    name: str,
    rows: Sequence[Mapping[str, Any]],
    fields: Sequence[str] | None = None,
) -> tuple[str, str]:
    """Write rows as both JSON and CSV; returns (json_path, csv_path).

    ``fields`` fixes the CSV column order; by default it is the union of
    row keys in first-seen order.
    """
    rows = list(rows)  # materialize once — generators must survive both passes
    json_path = save_json(name, rows)
    if fields is None:
        seen: dict[str, None] = {}
        for row in rows:
            for k in row:
                seen.setdefault(k, None)
        fields = list(seen)
    csv_path = os.path.join(results_dir(), f"{name}.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(fields), extrasaction="ignore")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: row.get(k, "") for k in fields})
    return json_path, csv_path


def tail_columns(
    ccts: np.ndarray, quantiles: Sequence[float] = (0.95, 0.99)
) -> dict[str, float]:
    """Absolute tail-CCT columns for one result row.

    The paper reports p95/p99 completion-time tails alongside the weighted
    aggregate; this derives ``{"p95_cct": ..., "p99_cct": ...}`` (via
    `repro_torch.core.scheduler.tail_cct`) from a realized per-coflow CCT
    vector so every exported row carries its tails.
    """
    return {
        f"p{round(q * 100):d}_cct": tail_cct(np.asarray(ccts), q)
        for q in quantiles
    }


def group_mean(
    rows: Iterable[Mapping[str, Any]],
    group_keys: Sequence[str],
    value_keys: Sequence[str],
) -> list[dict[str, Any]]:
    """Mean of ``value_keys`` per distinct ``group_keys`` combination,
    preserving first-seen group order."""
    acc: dict[tuple, dict[str, list[float]]] = {}
    order: list[tuple] = []
    for row in rows:
        key = tuple(row[k] for k in group_keys)
        if key not in acc:
            acc[key] = {v: [] for v in value_keys}
            order.append(key)
        for v in value_keys:
            acc[key][v].append(float(row[v]))
    out = []
    for key in order:
        entry: dict[str, Any] = dict(zip(group_keys, key))
        for v in value_keys:
            vals = acc[key][v]
            entry[v] = sum(vals) / len(vals)
        out.append(entry)
    return out
