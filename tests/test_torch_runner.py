"""The port's sharded sweep runner (`repro_torch.experiments.runner`) and
its bring-up (`repro_torch.launch.mesh`), ported from the reference's
``tests/test_runner.py``.

A sweep declared as (cell specs, ``make``) splits over workers in
contiguous balanced shards; each worker builds only its own instances;
the merged shard artifacts are byte-identical to one sweep over the whole
spec list, and to the reference's own `run_shard` / `merge_shards`
(compiled from source, `torch_fabric_reference`).  A cache shared between
shards lets a re-run compute no cell; ``gc_max_*`` keep it bounded.
`run_distributed` in one process is that single sweep, and two gloo
processes on 127.0.0.1 merge on rank 0 to the same rows.
"""

import json
import multiprocessing
import os
import socket
import sys
import time

import pytest
import torch

from repro_torch.experiments import (
    SweepCache,
    merge_shards,
    run_distributed,
    run_shard,
    shard_indices,
    sweep,
)
from repro_torch.experiments.runner import shard_name
from repro_torch.launch.mesh import init_distributed, process_shard
from repro_torch.traffic.instances import random_instance
from torch_fabric_reference import REF_RUNNER, reference_imports

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

SPECS = [{"seed": 50 + i, "num_coflows": 8 + 2 * (i % 3), "num_ports": 4} for i in range(7)]

_KW = dict(schemes=("ours", "wspt_order"), lp_method="exact", validate=False)
CPU = dict(device="cpu")
_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _make(spec):
    return random_instance(num_coflows=spec["num_coflows"], num_ports=spec["num_ports"],
                           num_cores=2, seed=spec["seed"])


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "results"))
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "default_cache"))
    monkeypatch.setenv("HYPOTHESIS_STORAGE_DIRECTORY", str(tmp_path / "hypothesis"))
    for name in _DIST_ENV:
        monkeypatch.delenv(name, raising=False)


def _single_sweep_rows(specs=SPECS, **kw):
    ref = sweep([_make(s) for s in specs], metas=[dict(s, cell=i) for i, s in enumerate(specs)],
                **{**_KW, **kw}, **CPU)
    return json.dumps(json.loads(json.dumps(ref.rows(), default=float)))


def _read(path):
    with open(path) as f:
        return json.dumps(json.load(f))


def _objects_on_disk(root):
    objdir = os.path.join(root, "objects")
    if not os.path.isdir(objdir):
        return 0
    return sum(len(files) for _, _, files in os.walk(objdir))


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 5, 7, 16])
def test_shard_partition_is_exact_and_contiguous(n):
    for k in (1, 2, 3, 5):
        chunks = [shard_indices(n, s, k) for s in range(k)]
        assert [i for c in chunks for i in c] == list(range(n))
        sizes = [len(c) for c in chunks]
        assert max(sizes) - min(sizes) <= 1
        assert chunks == [REF_RUNNER.shard_indices(n, s, k) for s in range(k)]


def test_shard_indices_reject_bad_shards():
    for args in ((4, 2, 2), (4, 0, 0), (4, -1, 2)):
        with pytest.raises(ValueError):
            shard_indices(*args)


def test_shard_name_sortable():
    names = [shard_name("x", s, 12) for s in range(12)]
    assert names == sorted(names)
    assert names[3] == REF_RUNNER.shard_name("x", 3, 12)


def test_run_shard_makes_only_its_own_instances():
    made = []

    def counting_make(spec):
        made.append(spec["seed"])
        return _make(spec)

    run_shard(SPECS, counting_make, shard=1, num_shards=3, **_KW, **CPU)
    assert made == [SPECS[i]["seed"] for i in shard_indices(7, 1, 3)]


def test_rows_carry_global_cell_ids():
    res = run_shard(SPECS, _make, shard=2, num_shards=3, **_KW, **CPU)
    assert sorted({r["cell"] for r in res.rows()}) == shard_indices(7, 2, 3)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_merge_equals_unsharded_and_reference(tmp_path, monkeypatch, num_shards):
    for shard in range(num_shards):
        run_shard(SPECS, _make, name="m", shard=shard, num_shards=num_shards, **_KW, **CPU)
    jpath, _ = merge_shards("m", num_shards)
    assert _read(jpath) == _single_sweep_rows()
    # The reference's own runner on the same specs merges to the same bytes.
    for name, mod in reference_imports().items():
        monkeypatch.setitem(sys.modules, name, mod)
    for shard in range(num_shards):
        REF_RUNNER.run_shard(SPECS, _make, name="r", shard=shard, num_shards=num_shards, **_KW)
    rpath, _ = REF_RUNNER.merge_shards("r", num_shards)
    assert _read(rpath) == _read(jpath)
    with open(jpath.replace(".json", ".csv")) as a, open(rpath.replace(".json", ".csv")) as b:
        assert a.read() == b.read()


def test_merge_missing_shard_raises():
    run_shard(SPECS, _make, name="q", shard=0, num_shards=2, **_KW, **CPU)
    with pytest.raises(FileNotFoundError):
        merge_shards("q", 2)


def test_shared_cache_across_shards(tmp_path):
    cache = str(tmp_path / "cache")
    for shard in range(2):
        run_shard(SPECS, _make, shard=shard, num_shards=2, cache=cache, **_KW, **CPU)
    res = run_shard(SPECS, _make, shard=1, num_shards=2, cache=cache, **_KW, **CPU)
    assert res.cache_stats["computed"] == 0
    full = sweep([_make(s) for s in SPECS], metas=[dict(s, cell=i) for i, s in enumerate(SPECS)],
                 cache=cache, **_KW, **CPU)
    assert full.cache_stats["computed"] == 0
    assert json.dumps(full.rows()) == _single_sweep_rows()


def test_run_shard_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_shard(SPECS, lambda s: made.append(s), **_KW)
    assert made == []


# ---------------------------------------------------------------------------
# gc budgets (reference tests/test_runner.py, TestGcBudget)
# ---------------------------------------------------------------------------


def test_bounded_cache_stays_under_budget(tmp_path):
    cache = str(tmp_path / "gc_cache")
    specs = SPECS[:4]
    budget = len(specs) * 2  # one generation: 4 cells x 2 schemes
    for rep in range(3):
        if rep:
            time.sleep(1.1)  # the LRU clock's 1 s resolution
        gen = [dict(s, seed=s["seed"] + 1000 * rep) for s in specs]
        run_shard(gen, _make, cache=cache, gc_max_cells=budget, **_KW, **CPU)
        assert len(SweepCache(cache)) <= budget, rep
        assert _objects_on_disk(cache) <= budget, rep
    gen = [dict(s, seed=s["seed"] + 2000) for s in specs]
    res = run_shard(gen, _make, cache=cache, gc_max_cells=budget, **_KW, **CPU)
    assert res.cache_stats["computed"] == 0


def test_byte_budget_evicts(tmp_path):
    cache = str(tmp_path / "gc_bytes")
    run_shard(SPECS[:4], _make, cache=cache, **_KW, **CPU)
    assert len(SweepCache(cache)) == 8
    run_shard(SPECS[:1], _make, cache=cache, gc_max_bytes=1, **_KW, **CPU)
    assert len(SweepCache(cache)) == 0
    assert _objects_on_disk(cache) == 0


def test_gc_budget_on_a_store_object(tmp_path):
    store = SweepCache(str(tmp_path / "obj"))
    run_shard(SPECS[:3], _make, cache=store, gc_max_cells=2, **_KW, **CPU)
    assert len(store) == 2 and len(SweepCache(store.root)) == 2


def test_gc_ignored_without_cache():
    res = run_shard(SPECS[:2], _make, gc_max_cells=1, **_KW, **CPU)
    assert res.cache_stats is None


# ---------------------------------------------------------------------------
# torch.distributed
# ---------------------------------------------------------------------------


def test_single_process_is_noop_init():
    assert init_distributed() is False
    assert init_distributed(num_processes=1) is False
    assert process_shard() == (0, 1)


def test_multi_process_without_coordinator_raises():
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0)


def test_run_distributed_single_process_is_one_sweep(tmp_path):
    run_distributed(SPECS, _make, name="d", **_KW, **CPU)
    assert _read(os.path.join(str(tmp_path / "results"), "d.json")) == _single_sweep_rows()


def test_run_distributed_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_distributed(SPECS, _make, name="d", **_KW)


@pytest.mark.parametrize("local_rank, want", [("1", 1), (None, 3)],
                         ids=["LOCAL_RANK", "rank"])
def test_run_distributed_binds_each_rank_to_its_card(monkeypatch, local_rank, want):
    """Several ranks on a host with several cards: an unindexed ``cuda``
    becomes the card ``LOCAL_RANK`` names, else the rank modulo the
    host's cards (rank 7 of 8 on 4 cards: card 3), set as the current
    device before the shard runs.  The card and the process group are
    stand-ins, so this runs on the host."""
    from repro_torch.experiments import runner
    from repro_torch.launch import mesh

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    current = []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(mesh, "init_distributed", lambda **kw: True)
    monkeypatch.setattr(mesh, "process_shard", lambda: (7, 8))
    monkeypatch.setattr(torch.distributed, "barrier", lambda: None)
    seen = {}

    def fake_shard(specs, make, *, device, **kw):
        seen.update(device=device, shard=kw["shard"], num_shards=kw["num_shards"])
        return sweep([], **CPU)

    monkeypatch.setattr(runner, "run_shard", fake_shard)
    run_distributed(SPECS, _make, name="d", **_KW)
    assert seen == dict(device=torch.device("cuda", want), shard=7, num_shards=8)
    assert current == [torch.device("cuda", want)]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, cache):
    torch.set_num_threads(1)
    run_distributed(SPECS, _make, name="g", coordinator_address=f"127.0.0.1:{port}",
                    num_processes=world, process_id=rank, cache=cache, **_KW, **CPU)
    assert process_shard() == (rank, world)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("use_env", [False, True], ids=["arguments", "environment"])
def test_two_gloo_processes_merge_to_one_sweep(tmp_path, monkeypatch, use_env):
    """Two processes each run `run_distributed` on the host; rank 0's
    merged rows equal one sweep's.  The children inherit ``os.environ``
    (the results directory, and with ``use_env`` the torch contract); the
    join has its own time limit, so a hang fails the test."""
    port = _free_port()
    cache = str(tmp_path / "shared_cache")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(2):
        if use_env:
            monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
            monkeypatch.setenv("MASTER_PORT", str(port))
            monkeypatch.setenv("WORLD_SIZE", "2")
            monkeypatch.setenv("RANK", str(rank))
            target, args = _gloo_env_worker, (cache,)
        else:
            target, args = _gloo_worker, (rank, 2, port, cache)
        p = ctx.Process(target=target, args=args)
        p.start()
        procs.append(p)
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, "a gloo worker hung"
    assert [p.exitcode for p in procs] == [0, 0]
    results = str(tmp_path / "results")
    assert _read(os.path.join(results, "g.json")) == _single_sweep_rows()
    for shard in range(2):
        assert os.path.exists(os.path.join(results, f"{shard_name('g', shard, 2)}.json"))
    assert len(SweepCache(cache)) == 2 * len(SPECS)


def _gloo_env_worker(cache):
    torch.set_num_threads(1)
    run_distributed(SPECS, _make, name="g", cache=cache, **_KW, **CPU)
    torch.distributed.destroy_process_group()
