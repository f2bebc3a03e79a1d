"""The port's content-addressed sweep cache
(`repro_torch.experiments.cache`) against the JAX package's.

* Digests equal the reference's, bit for bit: `canonical_digest`,
  `instance_digest` (the same instance in both packages), `cell_key` and
  every registered key's `scheme_digest` (the port's `SchemeSpec` and
  `RefineSpec` carry the reference's field names, order and values).
* The cases of the reference's ``tests/test_cache.py`` against the port's
  `SweepCache` and `sweep` on the CPU: key sensitivity, hit and miss, a
  manifest that survives a restart, `flush` merging two writers, a
  dangling entry healing to a miss, LRU `gc` by cells and by bytes, a
  replay computing no cell, a perturbed instance recomputing exactly its
  cells, a changed configuration or fingerprint missing, cached and fresh
  rows byte-identical (JSON and CSV), certificates carried in the cache.
* The port's divergences by design: `code_fingerprint` covers the CUDA
  sources under ``csrc/`` (a copy of the package, edited, changes it), and
  the config digest holds the device where the LP is the subgradient
  solver (``"batch"``, ``"subgradient"``) and equals the reference's
  under ``"exact"``.
"""

import dataclasses
import importlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.traffic.instances import random_instance as ref_random_instance
from repro_torch.convert import from_reference
from repro_torch.experiments import SweepCache, code_fingerprint, sweep
from repro_torch.experiments.cache import (
    canonical_digest,
    cell_key,
    instance_digest,
    scheme_digest,
)
from repro_torch.experiments.results import save_rows
from repro_torch.pipeline import list_schemes
from repro_torch.traffic.instances import random_instance
from torch_fabric_reference import REF_CACHE, REF_SPEC, reference_imports

# The package's `sweep` attribute is the function; this is its module.
sweep_mod = importlib.import_module("repro_torch.experiments.sweep")
cache_mod = importlib.import_module("repro_torch.experiments.cache")

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "results"))
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "default_cache"))
    monkeypatch.setenv("HYPOTHESIS_STORAGE_DIRECTORY", str(tmp_path / "hypothesis"))


def _ens(n=3, seed0=40):
    return [
        random_instance(num_coflows=8 + 2 * s, num_ports=4, num_cores=2, seed=seed0 + s)
        for s in range(n)
    ]


_KW = dict(schemes=("ours", "wspt_order"), lp_method="exact", validate=False, device="cpu")

_CONFIG = dict(
    lp_method="exact", lp_iters=100, m_quantum=8, p_quantum=8, discipline="greedy",
    alloc="batch", circuit="batch", circuit_engine="auto", certify=False,
)


# ---------------------------------------------------------------------------
# Digests against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,span", [(5, 0.0), (6, 30.0), (7, 0.0)])
def test_instance_digest_equals_reference(seed, span):
    ref = ref_random_instance(num_coflows=9, num_ports=4, num_cores=3, seed=seed,
                              release_span=span)
    assert instance_digest(from_reference(ref, "cpu")) == REF_CACHE.instance_digest(ref)


@pytest.mark.parametrize("obj", [
    _CONFIG,
    {**_CONFIG, "refine": None, "m_quantum": None},
    {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": [1, 2.5, "x", None, True]},
    {"f": np.float64(0.1), "i": np.int64(3), "t": (1, (2, 3))},
], ids=["config", "none_quanta", "arrays", "scalars"])
def test_canonical_digest_equals_reference(obj):
    assert canonical_digest(obj) == REF_CACHE.canonical_digest(obj)


def test_refine_spec_digest_equals_reference():
    from repro_torch.pipeline import RefineSpec

    for spec, ref in [(RefineSpec(), REF_SPEC.RefineSpec()),
                      (RefineSpec(rounds=3, seed=7), REF_SPEC.RefineSpec(rounds=3, seed=7))]:
        assert canonical_digest({"refine": spec}) == REF_CACHE.canonical_digest({"refine": ref})


@pytest.mark.parametrize("scheme", list(list_schemes()))
def test_scheme_digest_equals_reference(scheme, monkeypatch):
    for name, mod in reference_imports().items():
        monkeypatch.setitem(__import__("sys").modules, name, mod)
    assert scheme in REF_SPEC.list_schemes()
    assert scheme_digest(scheme) == REF_CACHE.scheme_digest(scheme)


def test_cell_key_equals_reference_and_mixes_all_parts():
    parts = ["i", "s", "c", "f"]
    k0 = cell_key(*parts)
    assert k0 == REF_CACHE.cell_key(*parts) and len(k0) == 64
    for j in range(4):
        p = list(parts)
        p[j] = "x"
        assert cell_key(*p) != k0


def test_instance_digest_deterministic():
    assert instance_digest(random_instance(seed=5)) == instance_digest(random_instance(seed=5))


@pytest.mark.parametrize("field", ["demands", "weights", "releases", "rates", "delta"])
def test_instance_digest_sensitive(field):
    inst = random_instance(seed=5)
    if field == "delta":
        other = dataclasses.replace(inst, delta=inst.delta + 1.0)
    else:
        arr = np.array(getattr(inst, field), copy=True)
        arr.flat[0] += 1.0
        other = dataclasses.replace(inst, **{field: arr})
    assert instance_digest(inst) != instance_digest(other)


def test_scheme_digest_separates_schemes():
    assert scheme_digest("ours") != scheme_digest("wspt_order")


def test_config_digest_sensitive():
    d0 = canonical_digest(_CONFIG)
    assert d0 == canonical_digest(dict(_CONFIG))
    for k, v in [("lp_iters", 200), ("discipline", "reserving"),
                 ("circuit_engine", "kernel"), ("certify", True)]:
        assert canonical_digest({**_CONFIG, k: v}) != d0


def test_code_fingerprint_stable_in_process():
    assert code_fingerprint() == code_fingerprint()


# ---------------------------------------------------------------------------
# Divergences by design: csrc in the fingerprint, the device in the config
# ---------------------------------------------------------------------------


def test_code_fingerprint_covers_cuda_sources(tmp_path):
    import repro_torch

    pkg = tmp_path / "repro_torch"
    shutil.copytree(os.path.dirname(repro_torch.__file__), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = cache_mod._package_digest(str(pkg))
    assert before == cache_mod._package_digest(str(pkg))
    assert before == code_fingerprint()
    for name in ("pair_resolve.cu", "launch.cuh"):
        src = pkg / "csrc" / name
        text = src.read_text()
        src.write_text(text + "\n// edited\n")
        assert cache_mod._package_digest(str(pkg)) != before, name
        src.write_text(text)
        assert cache_mod._package_digest(str(pkg)) == before
    (pkg / "csrc" / "notes.txt").write_text("not a source")
    assert cache_mod._package_digest(str(pkg)) == before
    (pkg / "core" / "lp.py").write_text((pkg / "core" / "lp.py").read_text() + "\n")
    assert cache_mod._package_digest(str(pkg)) != before


@pytest.mark.parametrize("lp_method", ["batch", "subgradient", "exact"])
def test_config_digest_holds_the_device_where_the_lp_does(lp_method):
    kw = {**_CONFIG, "lp_method": lp_method, "refine": None}
    cpu = sweep_mod.config_digest(**kw, device=torch.device("cpu"))
    cuda = sweep_mod.config_digest(**kw, device=torch.device("cuda"))
    reference = REF_CACHE.canonical_digest(
        {k: kw[k] for k in (*_CONFIG, "refine")})
    if lp_method == "exact":
        assert cpu == cuda == reference
    else:
        assert cpu != cuda and reference not in (cpu, cuda)
        assert cpu == REF_CACHE.canonical_digest({**kw, "device": "cpu"})


def test_cpu_cells_are_not_served_to_another_device(tmp_path, monkeypatch):
    """A batch-LP cell computed on the host keys on the host: the same
    sweep keyed for the card looks up other keys."""
    ens = _ens(2)
    kw = dict(schemes=("ours",), lp_method="batch", lp_iters=40, validate=False)
    sweep(ens, cache=str(tmp_path / "c"), device="cpu", **kw)
    cache = SweepCache(str(tmp_path / "c"))
    cfg_cpu = sweep_mod.config_digest(
        lp_method="batch", lp_iters=40, m_quantum=8, p_quantum=8, discipline="greedy",
        alloc="batch", circuit="batch", circuit_engine="auto", certify=False, refine=None,
        device=torch.device("cpu"))
    cfg_cuda = sweep_mod.config_digest(
        lp_method="batch", lp_iters=40, m_quantum=8, p_quantum=8, discipline="greedy",
        alloc="batch", circuit="batch", circuit_engine="auto", certify=False, refine=None,
        device=torch.device("cuda"))
    for inst in ens:
        keys = [cell_key(instance_digest(inst), scheme_digest("ours"), c, cache.fingerprint)
                for c in (cfg_cpu, cfg_cuda)]
        assert cache.get(keys[0]) is not None
        assert cache.get(keys[1]) is None


# ---------------------------------------------------------------------------
# The store (reference tests/test_cache.py)
# ---------------------------------------------------------------------------


def test_put_get_round_trip(tmp_path):
    c = SweepCache(str(tmp_path))
    payload = {"total_weighted_cct": 12.5, "ccts": [1.0, 2.5]}
    c.put("k" * 64, payload)
    c.flush()
    assert SweepCache(str(tmp_path)).get("k" * 64) == payload
    assert os.path.exists(tmp_path / "objects" / "kk" / f"{'k' * 64}.json")


def test_get_missing_is_none(tmp_path):
    c = SweepCache(str(tmp_path))
    assert c.get("a" * 64) is None
    assert c.stats.as_dict() == {"hits": 0, "misses": 1, "stored": 0}


def test_default_root_reads_the_environment(tmp_path):
    assert SweepCache().root == str(tmp_path / "default_cache")


def test_manifest_schema_equals_reference(tmp_path):
    c = SweepCache(str(tmp_path))
    c.put("f" * 64, {"x": 1})
    c.flush()
    doc = json.loads((tmp_path / "manifest.json").read_text())
    assert doc["schema"] == REF_CACHE._MANIFEST_SCHEMA
    # The reference's store reads the port's manifest and objects.
    assert REF_CACHE.SweepCache(str(tmp_path), fingerprint="x").get("f" * 64) == {"x": 1}


def test_unknown_manifest_schema_raises(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"schema": "v0", "cells": {}}))
    with pytest.raises(ValueError, match="schema"):
        SweepCache(str(tmp_path))


def test_missing_object_self_heals(tmp_path):
    c = SweepCache(str(tmp_path))
    c.put("b" * 64, {"x": 1})
    c.flush()
    next((tmp_path / "objects").rglob("*.json")).unlink()
    assert SweepCache(str(tmp_path)).get("b" * 64) is None


def test_manifest_merges_concurrent_writers(tmp_path):
    c1, c2 = SweepCache(str(tmp_path)), SweepCache(str(tmp_path))
    c1.put("c" * 64, {"x": 1})
    c2.put("d" * 64, {"y": 2})
    c1.flush()
    c2.flush()
    c3 = SweepCache(str(tmp_path))
    assert c3.get("c" * 64) == {"x": 1}
    assert c3.get("d" * 64) == {"y": 2}


def _fill(c, n, size=100):
    # Strictly increasing LRU stamps (the clock's 1 s resolution would tie).
    keys = [format(i, "x") * 32 for i in range(n)]
    for i, k in enumerate(keys):
        c.put(k, {"blob": "x" * size})
        c._manifest[k]["created"] = f"2026-01-01T00:00:{i:02d}Z"
    return keys


def test_gc_noop_under_budget(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 3)
    stats = c.gc(max_bytes=10**9)
    assert stats["evicted"] == 0 and stats["kept"] == 3
    assert all(c.get(k) is not None for k in keys)


def test_gc_evicts_oldest_first(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 4)
    sz = os.path.getsize(c._object_path(keys[0]))
    stats = c.gc(max_bytes=2 * sz)
    assert stats["evicted"] == 2 and stats["bytes"] <= 2 * sz
    assert stats["freed_bytes"] == 2 * sz
    assert c.get(keys[0]) is None and c.get(keys[1]) is None
    assert c.get(keys[2]) is not None and c.get(keys[3]) is not None
    assert not os.path.exists(c._object_path(keys[0]))


def test_gc_hit_refreshes_lru_rank(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 3)
    assert c.get(keys[0]) is not None
    sz = os.path.getsize(c._object_path(keys[0]))
    c.gc(max_bytes=sz)
    assert c.get(keys[0]) is not None
    assert c.get(keys[1]) is None and c.get(keys[2]) is None


def test_gc_max_cells_budget(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 5)
    assert c.gc(max_cells=2)["kept"] == 2
    assert [k for k in keys if c.get(k) is not None] == keys[3:]


def test_gc_heals_dangling_entries(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 3)
    os.remove(c._object_path(keys[1]))
    stats = c.gc()
    assert stats == {"scanned": 3, "kept": 2, "evicted": 0, "healed": 1,
                     "freed_bytes": 0, "bytes": stats["bytes"]}
    doc = json.loads((tmp_path / "manifest.json").read_text())
    assert sorted(doc["cells"]) == sorted([keys[0], keys[2]])


def test_gc_eviction_survives_restart(tmp_path):
    c = SweepCache(str(tmp_path))
    keys = _fill(c, 4)
    c.flush()
    c.gc(max_cells=1)
    c2 = SweepCache(str(tmp_path))
    assert len(c2) == 1
    assert c2.get(keys[3]) is not None
    assert all(c2.get(k) is None for k in keys[:3])


def test_gc_merges_unflushed_disk_entries(tmp_path):
    other = SweepCache(str(tmp_path))
    other.put("e" * 64, {"x": 1})
    other.flush()
    c = SweepCache(str(tmp_path))
    c._manifest = {}
    assert c.gc(max_bytes=10**9)["kept"] == 1


# ---------------------------------------------------------------------------
# Sweep integration (reference tests/test_cache.py)
# ---------------------------------------------------------------------------


def test_replay_computes_zero_cells(tmp_path):
    ens = _ens()
    fresh = sweep(ens, cache=str(tmp_path), **_KW)
    assert fresh.cache_stats["computed"] == fresh.cache_stats["cells"] == 6
    replay = sweep(ens, cache=str(tmp_path), **_KW)
    assert replay.cache_stats["computed"] == 0 and replay.cache_stats["hits"] == 6
    assert replay.lp_time_s == 0.0


def test_restart_serves_hits(tmp_path):
    ens = _ens()
    sweep(ens, cache=SweepCache(str(tmp_path)), **_KW)
    assert sweep(ens, cache=SweepCache(str(tmp_path)), **_KW).cache_stats["computed"] == 0


def test_perturbed_instance_recomputes_only_its_cells(tmp_path):
    ens = _ens()
    sweep(ens, cache=str(tmp_path), **_KW)
    w = np.array(ens[1].weights, copy=True)
    w[0] += 1.0
    ens[1] = dataclasses.replace(ens[1], weights=w)
    res = sweep(ens, cache=str(tmp_path), **_KW)
    assert res.cache_stats == {"cells": 6, "hits": 4, "misses": 2, "computed": 2}


def test_added_scheme_recomputes_only_new_column(tmp_path):
    ens = _ens()
    sweep(ens, cache=str(tmp_path), **_KW)
    res = sweep(ens, cache=str(tmp_path),
                **{**_KW, "schemes": ("ours", "wspt_order", "load_only")})
    assert res.cache_stats["hits"] == 6 and res.cache_stats["computed"] == 3


def test_config_change_invalidates(tmp_path):
    ens = _ens(2)
    sweep(ens, cache=str(tmp_path), **_KW)
    res = sweep(ens, cache=str(tmp_path), **{**_KW, "discipline": "reserving"})
    assert res.cache_stats["hits"] == 0


def test_fingerprint_change_invalidates(tmp_path):
    ens = _ens(2)
    sweep(ens, cache=str(tmp_path), **_KW)
    res = sweep(ens, cache=SweepCache(str(tmp_path), fingerprint="deadbeef"), **_KW)
    assert res.cache_stats["hits"] == 0 and res.cache_stats["computed"] == 4


def test_rows_byte_identical(tmp_path):
    ens = _ens()
    plain = sweep(ens, **_KW)
    fresh = sweep(ens, cache=str(tmp_path), **_KW)
    replay = sweep(ens, cache=str(tmp_path), **_KW)
    assert len({json.dumps(r.rows(), default=float) for r in (plain, fresh, replay)}) == 1


def test_artifact_files_byte_identical(tmp_path, monkeypatch):
    ens = _ens(2)
    out = tmp_path / "out"
    monkeypatch.setenv("REPRO_RESULTS", str(out))
    save_rows("parity_fresh", sweep(ens, **_KW).rows())
    sweep(ens, cache=str(tmp_path / "cache"), **_KW)
    replay = sweep(ens, cache=str(tmp_path / "cache"), **_KW)
    assert replay.cache_stats["computed"] == 0
    save_rows("parity_replay", replay.rows())
    for ext in ("json", "csv"):
        a = (out / f"parity_fresh.{ext}").read_bytes()
        b = (out / f"parity_replay.{ext}").read_bytes()
        assert a == b


def test_certified_sweep_caches_cert_fields(tmp_path):
    ens = _ens(2)
    kw = dict(schemes=("ours",), lp_method="exact", validate=False, certify=True,
              device="cpu")
    fresh = sweep(ens, cache=str(tmp_path), **kw)
    replay = sweep(ens, cache=str(tmp_path), **kw)
    assert replay.cache_stats["computed"] == 0
    assert json.dumps(fresh.rows(), default=float) == json.dumps(replay.rows(), default=float)
    for row in replay.rows():
        assert row["approx_ratio"] <= row["bound"] + 1e-9
        assert row["certified_reserving"] is True


def test_certify_without_ours_rejected(tmp_path):
    with pytest.raises(ValueError, match="ours"):
        sweep(_ens(1), cache=str(tmp_path), schemes=("wspt_order",), lp_method="exact",
              certify=True, device="cpu")


def test_batch_lp_replay_is_byte_identical(tmp_path):
    """Batch-LP cells (f32 LP objectives, f64 CCTs) round-trip through the
    cache's JSON exactly."""
    ens = _ens(3)
    kw = dict(schemes=("ours", "load_only"), lp_method="batch", lp_iters=60,
              validate=False, device="cpu")
    fresh = sweep(ens, cache=str(tmp_path), **kw)
    replay = sweep(ens, cache=str(tmp_path), **kw)
    assert replay.cache_stats["computed"] == 0
    assert json.dumps(fresh.rows()) == json.dumps(replay.rows())
    for rec in replay.records:
        for res in rec.results.values():
            assert res.from_cache and res.ccts.dtype == np.float64
