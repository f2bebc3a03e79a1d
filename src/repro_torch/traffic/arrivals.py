"""Arrival-process generators for the streaming scheduler (NumPy copy of
`repro.traffic.arrivals`: the same seeds give the same arrays).

Each generator returns a sorted float64 array of `num` absolute arrival
times (milliseconds, starting near 0) and is fully determined by its
`seed`.  They model the arrival-process families the online-scheduling
literature sweeps over (cf. Icarus's stationary/bursty workload
generators and psim's periodic-job generators):

  * `poisson_arrivals`     — stationary Poisson process (exponential
    inter-arrivals with mean `mean_interarrival_ms`);
  * `onoff_arrivals`       — Markov-modulated on/off (bursty) process:
    exponential ON/OFF sojourns, arrivals only while ON;
  * `diurnal_arrivals`     — non-homogeneous Poisson with a sinusoidal
    day/night rate profile, drawn by thinning;
  * `periodic_waves`       — periodic ML-training waves: `wave_size`
    near-simultaneous arrivals every `period_ms` with per-coflow jitter.

`with_releases` stamps a release vector onto an existing
`CoflowInstance` so any offline workload can be replayed online.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.coflow import CoflowInstance

__all__ = [
    "poisson_arrivals",
    "onoff_arrivals",
    "diurnal_arrivals",
    "periodic_waves",
    "with_releases",
]


def poisson_arrivals(
    num: int, *, mean_interarrival_ms: float = 1000.0, seed: int = 0
) -> np.ndarray:
    """Stationary Poisson process: cumulative exponential inter-arrivals."""
    if num <= 0:
        return np.zeros(0)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_ms, size=num)
    return np.cumsum(gaps) - gaps[0]  # first arrival at t=0


def onoff_arrivals(
    num: int,
    *,
    mean_on_ms: float = 2000.0,
    mean_off_ms: float = 8000.0,
    mean_interarrival_on_ms: float = 100.0,
    seed: int = 0,
) -> np.ndarray:
    """Markov-modulated on/off (bursty) process.

    The source alternates exponential ON sojourns (mean `mean_on_ms`),
    during which arrivals form a Poisson process with mean inter-arrival
    `mean_interarrival_on_ms`, and exponential OFF sojourns (mean
    `mean_off_ms`) with no arrivals.  Burstiness ratio = the long-run
    rate while ON over the overall average rate:
    (mean_on + mean_off) / mean_on.
    """
    if num <= 0:
        return np.zeros(0)
    rng = np.random.default_rng(seed)
    out = np.empty(num)
    t = 0.0
    filled = 0
    while filled < num:
        on_end = t + rng.exponential(mean_on_ms)
        while filled < num:
            t += rng.exponential(mean_interarrival_on_ms)
            if t > on_end:
                t = on_end
                break
            out[filled] = t
            filled += 1
        t += rng.exponential(mean_off_ms)
    return out - out[0]


def diurnal_arrivals(
    num: int,
    *,
    period_ms: float = 86_400.0,
    mean_interarrival_ms: float = 1000.0,
    depth: float = 0.8,
    seed: int = 0,
) -> np.ndarray:
    """Non-homogeneous Poisson with sinusoidal rate, drawn by thinning.

    The instantaneous rate is
    ``lam(t) = lam0 * (1 + depth * sin(2*pi*t / period_ms))`` with
    ``lam0 = 1 / mean_interarrival_ms``; candidates are drawn at the
    peak rate ``lam0 * (1 + depth)`` and kept with probability
    ``lam(t) / lam_peak`` (Lewis–Shedler thinning).  `depth` in [0, 1)
    sets day/night contrast.
    """
    if num <= 0:
        return np.zeros(0)
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    rng = np.random.default_rng(seed)
    lam_peak = (1.0 + depth) / mean_interarrival_ms
    out = np.empty(num)
    t = 0.0
    filled = 0
    while filled < num:
        t += rng.exponential(1.0 / lam_peak)
        lam_t = (1.0 + depth * np.sin(2.0 * np.pi * t / period_ms)) / (
            mean_interarrival_ms
        )
        if rng.random() <= lam_t / lam_peak:
            out[filled] = t
            filled += 1
    return out - out[0]


def periodic_waves(
    num: int,
    *,
    period_ms: float = 10_000.0,
    wave_size: int = 8,
    jitter_ms: float = 50.0,
    seed: int = 0,
) -> np.ndarray:
    """Periodic ML-training waves: bursts of `wave_size` jobs every period.

    Wave ``w`` lands at ``w * period_ms``; each coflow in the wave gets
    an independent uniform [0, jitter_ms) offset (stragglers of a
    synchronized training step).  Returns sorted absolute times.
    """
    if num <= 0:
        return np.zeros(0)
    if wave_size <= 0:
        raise ValueError(f"wave_size must be positive, got {wave_size}")
    rng = np.random.default_rng(seed)
    waves = np.repeat(np.arange((num + wave_size - 1) // wave_size), wave_size)
    base = waves[:num] * period_ms
    # No renormalization: wave w's base stays at exactly w * period_ms, so
    # the first arrival is the first wave's smallest jitter (near 0).
    return np.sort(base + rng.uniform(0.0, max(jitter_ms, 1e-12), size=num))


def with_releases(
    instance: CoflowInstance, arrivals: np.ndarray
) -> CoflowInstance:
    """Return a copy of `instance` with `arrivals` as its release vector.

    Arrivals are assigned to coflows in index order (coflow m arrives at
    ``arrivals[m]``); they need not be sorted — the streaming service
    admits by release time regardless of index order.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.shape != (instance.num_coflows,):
        raise ValueError(
            f"arrivals shape {arrivals.shape} != ({instance.num_coflows},)"
        )
    return dataclasses.replace(instance, releases=arrivals.copy())
