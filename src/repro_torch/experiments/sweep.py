"""Instance sweeps: one LP phase, batch-first scheme runs (port of
`repro.experiments.sweep`).

`sweep` is the engine behind the figure reproductions: it takes a whole
ensemble, solves the ordering LP for all of it (`solve_ensemble_lp`, one
batched solve per shape bucket on the device), then runs every requested
scheme through `repro_torch.pipeline`.  With ``alloc="batch"`` each
scheme's `Pipeline.run_batch` packs the ensemble once into an
`EnsembleBatch` (shared between schemes through the stage cache) and runs
ordering, allocation and the calendar as one tensor pipeline;
``alloc="loop"`` runs `Pipeline.run` per instance (a one-member batch).

``cache=`` plugs in the content-addressed result cache
(`repro_torch.experiments.cache.SweepCache`): every (instance, scheme)
cell is keyed by instance + scheme + config + code fingerprint, a hit
skips the LP and the pipeline for that cell, and only missing cells are
computed and stored.  Re-running an identical sweep computes no cell; a
perturbed one recomputes exactly the changed cells.

``lp_method``:
  * ``"batch"``       -- the batched subgradient solver on ``device``.
  * ``"exact"``       -- per-instance HiGHS on the host; needed where a
                         true lower bound is (ratios, certificates).
  * ``"subgradient"`` -- the per-instance subgradient solver on
                         ``device`` (the `lp_terms` kernel on a card).

Every stage runs on ``device`` (the card by default; it raises without
one).  The reference's ``mesh`` member sharding is left for the launch
tooling (ROADMAP item 10b); a sharded sweep's rows equal the
single-device run's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import pipeline as pipeline_mod
from repro_torch.core import lp, scheduler, theory
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device
from repro_torch.experiments import cache as cache_mod
from repro_torch.experiments.ensemble import solve_ensemble_lp
from repro_torch.experiments.results import save_rows, tail_columns

__all__ = ["DEFAULT_SCHEMES", "InstanceRecord", "SweepResult", "sweep", "config_digest"]

DEFAULT_SCHEMES = pipeline_mod.PAPER_SCHEMES

#: LP methods whose solutions depend on the device (f32 Adam steps).
_DEVICE_LP_METHODS = ("batch", "subgradient")


@dataclasses.dataclass
class InstanceRecord:
    """Everything computed for one ensemble member.

    ``lp`` / ``results`` / certificates may be the cached stand-ins
    (`repro_torch.experiments.cache.CachedLP` etc.) when the cell came out
    of the sweep cache: they carry exactly the fields the row export reads.
    """

    index: int
    meta: dict[str, Any]
    lp: Any  # lp.LPSolution | cache.CachedLP
    results: dict[str, Any]  # scheme -> ScheduleResult | CachedScheduleResult
    cert_greedy: Any | None = None
    cert_reserving: Any | None = None

    def _base(self, base: str):
        """Normalization baseline; the first scheme run when the requested
        one (default "ours") was not part of the sweep."""
        return self.results.get(base) or next(iter(self.results.values()))

    def normalized(self, base: str = "ours") -> dict[str, float]:
        b = self._base(base).total_weighted_cct
        return {s: r.total_weighted_cct / b for s, r in self.results.items()}

    def tail_ratio(self, q: float, base: str = "ours") -> dict[str, float]:
        b = scheduler.tail_cct(self._base(base).ccts, q)
        return {s: scheduler.tail_cct(r.ccts, q) / b for s, r in self.results.items()}


@dataclasses.dataclass
class SweepResult:
    records: list[InstanceRecord]
    lp_method: str
    lp_time_s: float
    wall_time_s: float
    cache_stats: dict[str, int] | None = None

    def __len__(self) -> int:
        return len(self.records)

    def rows(self, base: str = "ours") -> list[dict[str, Any]]:
        """One flat row per (instance, scheme) -- the JSON/CSV export shape.

        Besides the normalized aggregate and tail ratios, every row carries
        the scheme's absolute ``p95_cct`` / ``p99_cct``.  Rows read the
        per-cell absolutes only, as Python floats, so cached and fresh
        cells export byte-identically.
        """
        out = []
        for rec in self.records:
            nw = rec.normalized(base)
            p95 = rec.tail_ratio(0.95, base)
            p99 = rec.tail_ratio(0.99, base)
            for s, res in rec.results.items():
                row: dict[str, Any] = {"instance": rec.index, **rec.meta}
                row.update(
                    scheme=s,
                    total_weighted_cct=float(res.total_weighted_cct),
                    norm_weighted_cct=nw[s],
                    norm_p95=p95[s],
                    norm_p99=p99[s],
                    **tail_columns(res.ccts),
                    lp_objective=float(rec.lp.objective),
                )
                if s == "ours" and rec.cert_greedy is not None:
                    row["approx_ratio"] = float(rec.cert_greedy.approx_ratio)
                    row["bound"] = float(rec.cert_greedy.bound)
                if s == "ours" and rec.cert_reserving is not None:
                    row["approx_ratio_reserving"] = float(rec.cert_reserving.approx_ratio)
                    row["certified_reserving"] = bool(rec.cert_reserving.ok())
                out.append(row)
        return out

    def save(self, name: str, base: str = "ours") -> tuple[str, str]:
        return save_rows(name, self.rows(base))


def _cell_payload(results: dict, scheme: str, sol, cert_g, cert_r) -> dict:
    """The cached absolutes of one (instance, scheme) cell."""
    res = results[scheme]
    payload: dict[str, Any] = {
        "total_weighted_cct": float(res.total_weighted_cct),
        "ccts": [float(c) for c in np.asarray(res.ccts, dtype=np.float64)],
        "lp_objective": float(sol.objective),
    }
    if scheme == "ours" and cert_g is not None:
        payload["cert_greedy"] = {
            "approx_ratio": float(cert_g.approx_ratio),
            "bound": float(cert_g.bound),
        }
    if scheme == "ours" and cert_r is not None:
        payload["cert_reserving"] = {
            "approx_ratio": float(cert_r.approx_ratio),
            "ok": bool(cert_r.ok()),
        }
    return payload


def config_digest(
    *,
    lp_method: str,
    lp_iters: int,
    m_quantum: int | None,
    p_quantum: int | None,
    discipline: str,
    alloc: str,
    circuit: str,
    circuit_engine: str,
    certify: bool,
    refine,
    device: torch.device,
) -> str:
    """Digest of everything in a sweep's configuration that sets a cell's
    value.  It equals the reference's, plus the device type where the LP
    is the f32 subgradient solver: its bits differ between the card and
    the host, while HiGHS, the allocation and the calendar give the same
    bits on both."""
    config = dict(
        lp_method=lp_method,
        lp_iters=lp_iters,
        m_quantum=m_quantum,
        p_quantum=p_quantum,
        discipline=discipline,
        alloc=alloc,
        circuit=circuit,
        circuit_engine=circuit_engine,
        certify=certify,
        # The sweep-level refine override (None when schemes run their
        # spec-pinned refine, which the scheme digest captures).
        refine=refine,
    )
    if lp_method in _DEVICE_LP_METHODS:
        config["device"] = torch.device(device).type
    return cache_mod.canonical_digest(config)


def sweep(
    instances: Sequence[CoflowInstance],
    *,
    schemes: Sequence[str] = DEFAULT_SCHEMES,
    lp_method: str = "batch",
    lp_iters: int = 3000,
    m_quantum: int | None = 8,
    p_quantum: int | None = 8,
    discipline: str = "greedy",
    alloc: str = "batch",
    circuit: str = "batch",
    circuit_engine: str = "auto",
    certify: bool = False,
    metas: Sequence[Mapping[str, Any]] | None = None,
    validate: bool = True,
    cache: "cache_mod.SweepCache | str | None" = None,
    refine=None,
    device: str | torch.device = "cuda",
) -> SweepResult:
    """Run an ensemble end to end with one shared LP phase on ``device``.

    ``metas`` attaches a dict of sweep coordinates (seed, K, N, ...) to
    each instance, carried into every exported row.  ``alloc`` selects the
    post-LP path: ``"batch"`` (each scheme's `Pipeline.run_batch`) or
    ``"loop"`` (`Pipeline.run` per instance).  ``circuit`` selects the
    list scheduler's backend within the batched path (``"batch"``, the
    padded calendar, or ``"loop"``, the per-instance host oracle);
    ``circuit_engine`` picks the calendar's executor (default ``"auto"``:
    the pair calendar on a card, the host's NumPy one on the CPU, or
    ``REPRO_CIRCUIT_ENGINE``).

    ``cache`` (a `SweepCache` or a cache-root path) keys every cell and
    computes only the misses: the LP runs over the instances with a
    missing cell, each scheme's pipeline over the instances missing it.

    ``certify=True`` certifies ours against the paper's Lemma 2-4 /
    Theorem 1 chain (greedy for the practical ratio, reserving for the
    per-coflow guarantee); it needs the exact LP.  The reserving rerun
    shares the ordering pass and the allocation through the stage cache.
    Certificates ride in the ours cell, so with a cache ``"ours"`` must be
    among the schemes.

    ``refine`` applies candidate-search refinement to every scheme (a
    `RefineSpec`, ``True`` or a field dict; schemes whose spec pins one,
    like ``ours_ls``, use theirs when ``refine`` is None); it joins the
    cell key.
    """
    device = resolve_device(device)
    instances = list(instances)
    schemes = tuple(schemes)
    if metas is None:
        metas = [{} for _ in instances]
    if len(metas) != len(instances):
        raise ValueError("metas length mismatch")
    if certify and lp_method != "exact":
        raise ValueError(
            "certify=True needs lp_method='exact': the subgradient objective "
            "upper-bounds the LP optimum and is not a valid ratio baseline"
        )
    if lp_method not in ("batch", "exact", "subgradient"):
        raise ValueError(f"unknown lp_method {lp_method!r}")
    if alloc not in ("batch", "loop"):
        raise ValueError(f"unknown alloc mode {alloc!r}")
    if circuit not in ("batch", "loop"):
        raise ValueError(f"unknown circuit mode {circuit!r}")
    if refine not in (None, False):
        from repro_torch.pipeline.refine import as_refine_spec

        refine = as_refine_spec(refine)
    else:
        refine = None
    if isinstance(cache, str):
        cache = cache_mod.SweepCache(cache)
    if cache is not None and certify and "ours" not in schemes:
        raise ValueError(
            "certify=True with a cache requires 'ours' among the schemes "
            "(certificates are stored in the OURS cell)"
        )

    t0 = time.perf_counter()
    n = len(instances)

    # ---- cell keying: which (instance, scheme) cells need computing ----
    # `validate` is left out: it checks, it does not change a value.
    keys: dict[tuple[int, str], str] = {}
    payloads: dict[tuple[int, str], dict] = {}
    if cache is not None:
        cfg = config_digest(
            lp_method=lp_method, lp_iters=lp_iters, m_quantum=m_quantum,
            p_quantum=p_quantum, discipline=discipline, alloc=alloc,
            circuit=circuit, circuit_engine=circuit_engine, certify=certify,
            refine=refine, device=device,
        )
        inst_digests = [cache_mod.instance_digest(inst) for inst in instances]
        schm_digests = {s: cache_mod.scheme_digest(s) for s in schemes}
        miss: set[tuple[int, str]] = set()
        for i in range(n):
            for s in schemes:
                key = cache_mod.cell_key(
                    inst_digests[i], schm_digests[s], cfg, cache.fingerprint
                )
                keys[(i, s)] = key
                payload = cache.get(key)
                if payload is None:
                    miss.add((i, s))
                else:
                    payloads[(i, s)] = payload
    else:
        miss = {(i, s) for i in range(n) for s in schemes}

    # ---- LP phase: only instances with at least one missing cell -------
    need_idx = sorted({i for i, _ in miss})
    sols_by_idx: dict[int, Any] = {}
    lp_time = 0.0
    if need_idx:
        sub = [instances[i] for i in need_idx]
        t_lp = time.perf_counter()
        if lp_method == "batch":
            sub_sols = solve_ensemble_lp(
                sub, iters=lp_iters, m_quantum=m_quantum, p_quantum=p_quantum,
                device=device,
            )
        elif lp_method == "exact":
            sub_sols = [lp.solve_exact(inst) for inst in sub]
        else:
            sub_sols = [
                lp.solve_subgradient(inst, iters=lp_iters, device=device) for inst in sub
            ]
        lp_time = time.perf_counter() - t_lp
        sols_by_idx = dict(zip(need_idx, sub_sols))

    # ---- scheme runs over each scheme's missing instances --------------
    # One stage_cache per distinct instance subset: schemes sharing a
    # subset (the all-miss case, and the certify-reserving rerun) share
    # one build, one ordering pass and one allocation.
    stage_caches: dict[tuple[int, ...], dict] = {}

    def _run(scheme_key: str, disc: str, idx: list[int]):
        pipe = pipeline_mod.get_pipeline(
            scheme_key, discipline=disc, circuit_backend=circuit,
            circuit_engine=circuit_engine,
        )
        sub = [instances[i] for i in idx]
        subsols = [sols_by_idx[i] for i in idx]
        if alloc == "batch":
            sc = stage_caches.setdefault(tuple(idx), {})
            res = pipe.run_batch(
                sub, lp_solutions=subsols, validate=validate, device=device,
                stage_cache=sc, refine=refine,
            )
        else:
            res = [
                pipe.run(inst, lp_solution=sol, validate=validate, device=device,
                         refine=refine)
                for inst, sol in zip(sub, subsols)
            ]
        return dict(zip(idx, res))

    scheme_results: dict[str, dict[int, Any]] = {}
    for s in schemes:
        idx_s = sorted(i for i, s2 in miss if s2 == s)
        scheme_results[s] = _run(s, discipline, idx_s) if idx_s else {}

    # ---- certification reruns (exact LP enforced above) ----------------
    ours_by_idx = reserving_by_idx = None
    if certify:
        if "ours" in schemes:
            cert_idx = sorted(i for i, s2 in miss if s2 == "ours")
            ours_by_idx = scheme_results["ours"]
        else:
            cert_idx = list(range(n))
            ours_by_idx = _run("ours", discipline, cert_idx)
        reserving_by_idx = _run("ours", "reserving", cert_idx) if cert_idx else {}

    # ---- assemble records (cached cells -> stand-ins), store misses ----
    records = []
    for i, (inst, meta) in enumerate(zip(instances, metas)):
        results: dict[str, Any] = {}
        cached_lp_obj = None
        cert_g = cert_r = None
        for s in schemes:
            if (i, s) in miss:
                results[s] = scheme_results[s][i]
            else:
                p = payloads[(i, s)]
                results[s] = cache_mod.CachedScheduleResult(
                    scheme=s,
                    total_weighted_cct=p["total_weighted_cct"],
                    ccts=np.asarray(p["ccts"], dtype=np.float64),
                )
                cached_lp_obj = p["lp_objective"]
        sol = sols_by_idx.get(i)
        if certify:
            if ours_by_idx is not None and i in ours_by_idx:
                res = ours_by_idx[i]
                cert_g = theory.certify(
                    inst, res.order, sol.completion, res.allocation, res.ccts
                )
                res_r = reserving_by_idx[i]
                cert_r = theory.certify(
                    inst, res_r.order, sol.completion, res_r.allocation, res_r.ccts
                )
            else:  # the ours cell was cached: certificates ride in its payload
                p = payloads[(i, "ours")]
                cg, cr = p.get("cert_greedy"), p.get("cert_reserving")
                if cg is not None:
                    cert_g = cache_mod.CachedCertificate(
                        approx_ratio=cg["approx_ratio"], bound=cg["bound"]
                    )
                if cr is not None:
                    cert_r = cache_mod.CachedCertificate(
                        approx_ratio=cr["approx_ratio"], bound=0.0, certified=cr["ok"]
                    )
        records.append(
            InstanceRecord(
                index=i,
                meta=dict(meta),
                lp=sol if sol is not None else cache_mod.CachedLP(cached_lp_obj),
                results=results,
                cert_greedy=cert_g,
                cert_reserving=cert_r,
            )
        )
        if cache is not None:
            for s in schemes:
                if (i, s) in miss:
                    cache.put(
                        keys[(i, s)],
                        _cell_payload(results, s, sol, cert_g, cert_r),
                        meta={"scheme": s},
                    )
    cache_stats = None
    if cache is not None:
        cache.flush()
        cache_stats = dict(
            cells=n * len(schemes),
            hits=n * len(schemes) - len(miss),
            misses=len(miss),
            computed=len(miss),
        )
    return SweepResult(
        records=records,
        lp_method=lp_method,
        lp_time_s=lp_time,
        wall_time_s=time.perf_counter() - t0,
        cache_stats=cache_stats,
    )
