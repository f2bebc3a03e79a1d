"""Instance sampling per the paper's experimental setup (Sec. V-A).

NumPy copy of `repro.traffic.instances` (same seeds, same bytes).

Default parameters (paper): N = 10 ports, M = 100 coflows sampled from the
trace, K = 3 cores with rates [10, 20, 30] (R = 60), delta = 8.  Weights are
positive (the trace has none; the literature samples them uniformly), and
release times are either zero or the trace arrival times rescaled.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.coflow import CoflowInstance
from repro_torch.traffic.facebook import synthesize_facebook_like, to_demands

__all__ = ["sample_instance", "paper_default_instance"]

_TRACE_CACHE: dict[int, list] = {}


def _trace(seed: int):
    if seed not in _TRACE_CACHE:
        _TRACE_CACHE[seed] = synthesize_facebook_like(seed=seed)
    return _TRACE_CACHE[seed]


def sample_instance(
    num_ports: int = 10,
    num_coflows: int = 100,
    rates=(10.0, 20.0, 30.0),
    delta: float = 8.0,
    seed: int = 0,
    release: str = "zero",  # "zero" | "trace"
    trace_seed: int = 0,
    trace_path: str | None = None,
) -> CoflowInstance:
    """Sample an N-port, M-coflow instance from the (synthetic) FB trace."""
    rng = np.random.default_rng(seed)
    if trace_path is not None:
        from repro_torch.traffic.facebook import load_fbt

        coflows = load_fbt(trace_path)
    else:
        coflows = _trace(trace_seed)
    # Random machine -> port mapping (N machines sampled as servers).
    machines = set()
    for cf in coflows:
        machines.update(int(x) for x in cf.mappers)
        machines.update(int(x) for x in cf.reducers)
    machines = np.asarray(sorted(machines))
    chosen = rng.choice(machines, size=num_ports, replace=False)
    port_map = {int(m): i for i, m in enumerate(chosen)}

    # Keep sampling coflows until M have nonzero demand on the chosen ports.
    perm = rng.permutation(len(coflows))
    demands, arrivals = [], []
    for idx in perm:
        cf = coflows[idx]
        mat = to_demands([cf], port_map, num_ports, rng)[0]
        if mat.sum() > 0:
            demands.append(mat)
            arrivals.append(cf.arrival_ms)
        if len(demands) == num_coflows:
            break
    if len(demands) < num_coflows:
        raise ValueError(
            f"trace only yields {len(demands)} nonzero coflows on {num_ports} ports"
        )
    demands = np.stack(demands)
    weights = rng.uniform(1.0, 10.0, size=num_coflows)
    if release == "zero":
        releases = np.zeros(num_coflows)
    elif release == "trace":
        arr = np.asarray(arrivals)
        arr = arr - arr.min()
        # Rescale so the arrival span is comparable to the service scale.
        span = demands.sum() / (sum(rates) * num_ports)
        releases = arr / max(arr.max(), 1e-9) * span
    else:
        raise ValueError(f"unknown release mode {release!r}")
    return CoflowInstance(
        demands=demands,
        weights=weights,
        releases=releases,
        rates=np.asarray(rates, dtype=np.float64),
        delta=delta,
    )


def paper_default_instance(seed: int = 0) -> CoflowInstance:
    """The paper's default setting: N=10, M=100, K=3, rates [10,20,30], delta=8."""
    return sample_instance(seed=seed)
