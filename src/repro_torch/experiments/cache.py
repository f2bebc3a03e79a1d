"""Content-addressed result cache for instance sweeps (port of
`repro.experiments.cache`).

Every sweep *cell* -- one (instance, scheme) pair under a fixed pipeline
configuration -- is keyed by a SHA-256 over

  * the **instance digest** (demand / weight / release / rate array bytes
    and dtypes, plus delta),
  * the **scheme digest** (the registered `SchemeSpec`, as data),
  * the **config digest** (LP method and iterations, bucket quanta,
    discipline, allocation and circuit paths, calendar engine, certify,
    refine; and, where the LP is the f32 subgradient solver, the device
    type, since the card's and the host's f32 Adam steps differ), and
  * the **code fingerprint** (package version + SHA-256 of every
    result-determining source, the CUDA sources under ``csrc/`` included).

The first three digests equal the reference's for the same instance,
scheme and configuration (with the exact LP, the config digest too).  A
hit short-circuits the LP and the pipeline; payloads hold the per-cell
absolutes the row export reads, so cached and fresh rows export
byte-identically.  On disk: ``objects/<k[:2]>/<key>.json`` plus a
``manifest.json`` that survives restarts and merges on flush, so shard
workers sharing one directory (`repro_torch.experiments.runner`)
interleave safely.

With ``m_quantum=None`` / ``p_quantum=None`` the LP's padded shape depends
on the ensemble, not the instance; cache keys hold the quanta, not the
co-members.  The fixed default quanta make padding per instance.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Mapping

import numpy as np

__all__ = [
    "CachedLP",
    "CachedCertificate",
    "CachedScheduleResult",
    "SweepCache",
    "CacheStats",
    "canonical_digest",
    "instance_digest",
    "scheme_digest",
    "code_fingerprint",
    "cell_key",
]

_MANIFEST_SCHEMA = "sweep-cache-manifest-v1"


def _utcnow() -> str:
    """ISO-8601 UTC second-resolution stamp -- the manifest's LRU clock."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# --------------------------------------------------------------- digests
def _canonical(obj: Any) -> Any:
    """Reduce `obj` to a JSON-stable structure for hashing.

    Arrays become (shape, dtype, content-hash) triples; dict keys are
    sorted by the JSON encoder; floats rely on ``repr`` round-tripping.
    """
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {
            "__ndarray__": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, Mapping):
        return {str(k): _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _canonical(dataclasses.asdict(obj))
    raise TypeError(f"cannot canonicalize {type(obj).__name__} for hashing")


def canonical_digest(obj: Any) -> str:
    """SHA-256 hex digest of the canonical JSON form of `obj`."""
    payload = json.dumps(_canonical(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def instance_digest(instance) -> str:
    """Digest of one `CoflowInstance`'s problem data (its f64 NumPy
    fields, as the reference's instance holds them)."""
    return canonical_digest(
        {
            "demands": np.asarray(instance.demands),
            "weights": np.asarray(instance.weights),
            "releases": np.asarray(instance.releases),
            "rates": np.asarray(instance.rates),
            "delta": float(instance.delta),
        }
    )


def scheme_digest(scheme: str) -> str:
    """Digest of the *registered spec* behind a scheme key (re-registering
    a scheme with other stages invalidates its cells)."""
    from repro_torch.pipeline.spec import get_scheme

    return canonical_digest(dataclasses.asdict(get_scheme(scheme)))


#: Subpackages whose ``.py`` sources can change a cell's value, and the
#: suffixes of the CUDA sources (a kernel's body lives under ``csrc/``).
_FINGERPRINT_DIRS = (
    "core",
    "pipeline",
    "kernels",
    "experiments",
    "streaming",
    "traffic",
)
_CSRC_SUFFIXES = (".cu", ".cuh")
_FINGERPRINT_CACHE: str | None = None


def _hash_tree(h, root: str, base: str, suffixes: tuple[str, ...]) -> None:
    for dirpath, _dirnames, filenames in sorted(os.walk(base)):
        for fn in sorted(filenames):
            if not fn.endswith(suffixes):
                continue
            path = os.path.join(dirpath, fn)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())


def _package_digest(pkg: str) -> str:
    """Version + digest of the result-determining sources under the
    package directory ``pkg``: every ``.py`` under `_FINGERPRINT_DIRS`,
    then every ``.cu`` / ``.cuh`` under ``csrc/``, in sorted relative-path
    order."""
    import repro_torch

    h = hashlib.sha256()
    h.update(getattr(repro_torch, "__version__", "0").encode())
    for sub in _FINGERPRINT_DIRS:
        base = os.path.join(pkg, sub)
        if os.path.isdir(base):
            _hash_tree(h, pkg, base, (".py",))
    csrc = os.path.join(pkg, "csrc")
    if os.path.isdir(csrc):
        _hash_tree(h, pkg, csrc, _CSRC_SUFFIXES)
    return h.hexdigest()


def code_fingerprint() -> str:
    """Package version + digest of the result-determining sources.

    Hashes the `repro_torch` subpackages whose code can change a sweep
    cell's value and the CUDA sources under ``csrc/``, so any source edit
    invalidates the whole cache.  Computed once per process.
    """
    global _FINGERPRINT_CACHE
    if _FINGERPRINT_CACHE is None:
        import repro_torch

        _FINGERPRINT_CACHE = _package_digest(
            os.path.dirname(os.path.abspath(repro_torch.__file__))
        )
    return _FINGERPRINT_CACHE


def cell_key(
    inst_digest: str, schm_digest: str, config_digest: str, fingerprint: str
) -> str:
    """The cache key of one sweep cell: hash of the four digests."""
    h = hashlib.sha256()
    for part in (inst_digest, schm_digest, config_digest, fingerprint):
        h.update(part.encode())
        h.update(b"|")
    return h.hexdigest()


# ----------------------------------------------------- cached stand-ins
@dataclasses.dataclass(frozen=True)
class CachedLP:
    """Stand-in for `lp.LPSolution` from a cache payload (the row export
    reads only ``objective``)."""

    objective: float
    method: str = "cached"


@dataclasses.dataclass(frozen=True)
class CachedCertificate:
    """Stand-in for `theory.CertificateReport` (the row export reads
    ``approx_ratio``, ``bound`` and ``ok()``)."""

    approx_ratio: float
    bound: float
    certified: bool = True

    def ok(self, tol: float = 1e-6) -> bool:
        return self.certified


@dataclasses.dataclass(frozen=True)
class CachedScheduleResult:
    """Stand-in for `scheduler.ScheduleResult` from a cache payload:
    exactly the absolutes the row export reads (circuits, orders and
    allocations are not cached)."""

    scheme: str
    total_weighted_cct: float
    ccts: np.ndarray

    @property
    def from_cache(self) -> bool:
        return True


# ------------------------------------------------------------ the cache
@dataclasses.dataclass
class CacheStats:
    """Cumulative counters over one `SweepCache` object's lifetime."""

    hits: int = 0
    misses: int = 0
    stored: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


class SweepCache:
    """Content-addressed sweep-cell store with a restart-surviving manifest.

    ``root`` defaults to ``$REPRO_CACHE`` or ``<results_dir>/cache``.
    ``fingerprint`` overrides `code_fingerprint` (to simulate a source
    edit, or to pin one fingerprint across a fleet).
    """

    def __init__(self, root: str | None = None, fingerprint: str | None = None):
        self.root = root or self.default_root()
        self.fingerprint = fingerprint or code_fingerprint()
        self.stats = CacheStats()
        self._manifest: dict[str, dict] = {}
        self._dirty = False
        self._load_manifest()

    @staticmethod
    def default_root() -> str:
        from repro_torch.experiments.results import results_dir

        return os.environ.get("REPRO_CACHE", os.path.join(results_dir(), "cache"))

    # -- manifest -------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    def _read_cells(self) -> dict[str, dict]:
        if not os.path.exists(self.manifest_path):
            return {}
        with open(self.manifest_path) as f:
            doc = json.load(f)
        if doc.get("schema") != _MANIFEST_SCHEMA:
            raise ValueError(
                f"unknown cache manifest schema {doc.get('schema')!r} "
                f"at {self.manifest_path}"
            )
        return doc.get("cells", {})

    def _load_manifest(self) -> None:
        self._manifest = self._read_cells()

    def _write_manifest(self, cells: dict[str, dict]) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = self.manifest_path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"schema": _MANIFEST_SCHEMA, "cells": cells}, f, indent=1)
        os.replace(tmp, self.manifest_path)
        self._manifest = cells
        self._dirty = False

    def flush(self) -> str:
        """Atomically persist the manifest, merging entries another worker
        may have flushed since we loaded (shared-directory shard runs)."""
        if not self._dirty and os.path.exists(self.manifest_path):
            return self.manifest_path
        merged = self._read_cells()
        merged.update(self._manifest)
        self._write_manifest(merged)
        return self.manifest_path

    def __len__(self) -> int:
        return len(self._manifest)

    # -- keys -----------------------------------------------------------
    def key(self, instance, scheme: str, config: Mapping[str, Any]) -> str:
        """Cell key for (instance, scheme) under `config`; `sweep`
        precomputes the digests to hash each array once."""
        return cell_key(
            instance_digest(instance),
            scheme_digest(scheme),
            canonical_digest(dict(config)),
            self.fingerprint,
        )

    # -- objects --------------------------------------------------------
    def _object_path(self, key: str) -> str:
        return os.path.join(self.root, "objects", key[:2], f"{key}.json")

    def get(self, key: str) -> dict | None:
        """Payload for `key`, or None (counts a hit or a miss).  A manifest
        entry whose object file vanished heals to a miss.  A hit stamps
        the entry's ``accessed`` time, the LRU clock of `gc`."""
        entry = self._manifest.get(key)
        if entry is not None:
            path = self._object_path(key)
            if os.path.exists(path):
                with open(path) as f:
                    self.stats.hits += 1
                    entry["accessed"] = _utcnow()
                    self._dirty = True
                    return json.load(f)
            del self._manifest[key]
            self._dirty = True
        self.stats.misses += 1
        return None

    def put(
        self, key: str, payload: Mapping[str, Any], meta: Mapping[str, Any] | None = None
    ) -> None:
        path = self._object_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=float)
        os.replace(tmp, path)
        self._manifest[key] = {
            "file": os.path.relpath(path, self.root),
            "created": _utcnow(),
            **({} if meta is None else dict(meta)),
        }
        self._dirty = True
        self.stats.stored += 1

    # -- eviction -------------------------------------------------------
    def gc(self, max_bytes: int | None = None, max_cells: int | None = None) -> dict[str, int]:
        """LRU eviction over the object store, with a self-healing rewrite.

        Merges the on-disk manifest into this one, drops entries whose
        object file is gone, then evicts least-recently-used cells (by
        ``accessed``, else ``created``; the key breaks ties) until the
        store holds at most ``max_bytes`` of payloads and ``max_cells``
        entries.  The manifest is then rewritten whole, not merged, so a
        stale copy cannot bring evicted cells back.  Run it quiesced.

        Returns ``scanned`` / ``kept`` / ``evicted`` / ``healed`` (dangling
        entries dropped), ``freed_bytes`` and the surviving ``bytes``.
        """
        merged = self._read_cells()
        merged.update(self._manifest)

        sizes: dict[str, int] = {}
        healed = 0
        for key in list(merged):
            try:
                sizes[key] = os.path.getsize(self._object_path(key))
            except OSError:
                del merged[key]
                healed += 1
        scanned = len(merged) + healed
        total = sum(sizes.values())

        def stamp(item):
            key, entry = item
            return (entry.get("accessed", entry.get("created", "")), key)

        evicted = freed = 0
        for key, _entry in sorted(merged.items(), key=stamp):
            over_bytes = max_bytes is not None and total > max_bytes
            over_cells = max_cells is not None and len(merged) > max_cells
            if not (over_bytes or over_cells):
                break
            path = self._object_path(key)
            try:
                os.remove(path)
            except OSError:
                pass
            try:  # drop the 2-hex prefix directory once it is empty
                os.rmdir(os.path.dirname(path))
            except OSError:
                pass
            del merged[key]
            total -= sizes[key]
            freed += sizes[key]
            evicted += 1

        self._write_manifest(merged)
        return dict(
            scanned=scanned, kept=len(merged), evicted=evicted,
            healed=healed, freed_bytes=freed, bytes=total,
        )
