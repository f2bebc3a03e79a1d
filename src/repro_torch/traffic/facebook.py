"""Facebook coflow trace: parser + offline synthetic stand-in (NumPy copy
of `repro.traffic.facebook`).

The paper evaluates on the public `coflow-benchmark` Facebook trace (526
coflows from a 3000-machine / 150-rack MapReduce cluster, reduced to a
150-port fabric).  The real file is not available offline, so this module
provides both:

  * ``load_fbt(path)`` — parser for the real FBT format::

        <num_machines> <num_coflows>
        <id> <arrival_ms> <num_mappers> <m1> ... <num_reducers> <r1:sizeMB> ...

  * ``synthesize_facebook_like(...)`` — a deterministic generator matched to
    the published trace statistics used across the coflow literature:
    ~526 coflows on 150 ports, Poisson arrivals, heavy-tailed coflow sizes
    (Pareto), the classic width mix (~60% narrow coflows, a minority very
    wide), and skewed per-receiver sender splits.  Receiver loads are split
    pseudo-uniformly among senders with a small perturbation, exactly the
    matrix-construction procedure of paper Sec. V-A.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TraceCoflow", "load_fbt", "synthesize_facebook_like", "to_demands"]


@dataclasses.dataclass
class TraceCoflow:
    coflow_id: int
    arrival_ms: float
    mappers: np.ndarray  # machine ids of senders
    reducers: np.ndarray  # machine ids of receivers
    reducer_mb: np.ndarray  # per-receiver total received MB


def load_fbt(path: str) -> list[TraceCoflow]:
    """Parse the coflow-benchmark FBT trace format."""
    out: list[TraceCoflow] = []
    with open(path) as f:
        header = f.readline().split()
        _num_machines, num_coflows = int(header[0]), int(header[1])
        for _ in range(num_coflows):
            parts = f.readline().split()
            if not parts:
                break
            cid = int(parts[0])
            arrival = float(parts[1])
            nm = int(parts[2])
            mappers = np.asarray([int(x) for x in parts[3 : 3 + nm]])
            off = 3 + nm
            nr = int(parts[off])
            reducers, sizes = [], []
            for tok in parts[off + 1 : off + 1 + nr]:
                rid, mb = tok.split(":")
                reducers.append(int(rid))
                sizes.append(float(mb))
            out.append(
                TraceCoflow(
                    coflow_id=cid,
                    arrival_ms=arrival,
                    mappers=mappers,
                    reducers=np.asarray(reducers),
                    reducer_mb=np.asarray(sizes),
                )
            )
    return out


def synthesize_facebook_like(
    num_coflows: int = 526,
    num_machines: int = 150,
    seed: int = 0,
    mean_interarrival_ms: float = 1000.0,
) -> list[TraceCoflow]:
    """Deterministic FB-like trace (see module docstring)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(mean_interarrival_ms, size=num_coflows))
    out: list[TraceCoflow] = []
    for c in range(num_coflows):
        # Width mix from the published trace: most coflows are narrow.
        # Category bounds scale with the machine count so small synthetic
        # fabrics remain valid.
        narrow_hi = max(2, min(5, num_machines // 2))
        med_hi = max(narrow_hi + 1, min(30, num_machines // 3))
        wide_hi = max(med_hi + 1, num_machines // 2)
        u = rng.random()
        if u < 0.52:  # narrow: 1-4 mappers/reducers
            nm = rng.integers(1, narrow_hi)
            nr = rng.integers(1, narrow_hi)
        elif u < 0.85:  # medium
            nm = rng.integers(narrow_hi, med_hi)
            nr = rng.integers(narrow_hi, med_hi)
        else:  # wide shuffle
            nm = rng.integers(med_hi, wide_hi)
            nr = rng.integers(med_hi, wide_hi)
        mappers = rng.choice(num_machines, size=int(nm), replace=False)
        reducers = rng.choice(num_machines, size=int(nr), replace=False)
        # Heavy-tailed total size (Pareto alpha ~1.2), split over receivers
        # with lognormal skew.
        total_mb = float((rng.pareto(1.2) + 1.0) * 8.0)
        split = rng.lognormal(mean=0.0, sigma=0.8, size=int(nr))
        reducer_mb = total_mb * split / split.sum()
        out.append(
            TraceCoflow(
                coflow_id=c,
                arrival_ms=float(arrivals[c]),
                mappers=mappers,
                reducers=reducers,
                reducer_mb=reducer_mb,
            )
        )
    return out


def to_demands(
    coflows: list[TraceCoflow],
    port_map: dict[int, int],
    num_ports: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Build (M, N, N) demand matrices (paper Sec. V-A).

    Machines outside ``port_map`` are dropped.  Each receiver's traffic is
    split pseudo-uniformly across its coflow's mapped senders with a small
    random perturbation (+-20%) to avoid perfectly uniform splitting.
    """
    mats = []
    for cf in coflows:
        mat = np.zeros((num_ports, num_ports))
        senders = [port_map[m] for m in cf.mappers if m in port_map]
        if not senders:
            mats.append(mat)
            continue
        for rid, mb in zip(cf.reducers, cf.reducer_mb):
            if rid not in port_map:
                continue
            j = port_map[rid]
            share = np.full(len(senders), 1.0 / len(senders))
            share *= rng.uniform(0.8, 1.2, size=len(senders))
            share /= share.sum()
            for i, s in zip(senders, share):
                mat[i, j] += mb * s
        mats.append(mat)
    return np.stack(mats) if mats else np.zeros((0, num_ports, num_ports))
