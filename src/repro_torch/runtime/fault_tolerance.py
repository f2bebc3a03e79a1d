"""Fault tolerance: failure injection, restart, straggler policy (port of
`repro.runtime.fault_tolerance`).

On a cluster, failures surface as collective timeouts or missing
heartbeats; this module gives the trainer the same control flow with an
injectable failure source, so the recovery path runs in tests:

  * `FailureInjector` -- deterministic or probabilistic step failures (a
    lost node, a preemption), drawing from ``np.random.default_rng(seed)``
    as the reference does;
  * `run_with_restarts` -- the supervision loop: on `NodeFailure`, restore
    the newest checkpoint and resume after it, within a restart budget;
  * `StragglerMitigator` -- a per-step deadline from the running median;
    slow steps are recorded.

One divergence from the reference: `run_with_restarts` waits for the
checkpointer's in-flight write before it reads the newest step.  The
reference reads the directory at once, so after a save at step s and a
failure at s + 1 its restore point depends on the writer thread's timing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint.checkpointer import latest_step

__all__ = ["FailureInjector", "StragglerMitigator", "run_with_restarts", "NodeFailure"]


class NodeFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises `NodeFailure` on configured steps (or with probability p)."""

    fail_at_steps: tuple[int, ...] = ()
    probability: float = 0.0
    seed: int = 0
    max_failures: int = 10

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._count = 0

    def check(self, step: int) -> None:
        if self._count >= self.max_failures:
            return
        if step in self.fail_at_steps or (
            self.probability > 0 and self._rng.random() < self.probability
        ):
            self._count += 1
            raise NodeFailure(f"injected node failure at step {step}")


class StragglerMitigator:
    """Deadline-based straggler tracking: a step slower than ``factor`` x
    the median of the last ``window`` steps (once five are known) is a
    straggler; `deadline` is that limit."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.stragglers: list[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step's time; True if it was a straggler."""
        is_straggler = False
        if len(self.times) >= 5 and seconds > self.factor * self.p50():
            self.stragglers.append(step)
            is_straggler = True
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        return is_straggler

    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("inf")

    def deadline(self) -> float:
        return self.factor * self.p50()


def run_with_restarts(
    make_state: Callable[[], dict],
    train_loop: Callable[[dict, int], dict],
    checkpointer,
    total_steps: int,
    max_restarts: int = 5,
):
    """Run ``train_loop(state, start_step)``; on `NodeFailure`, wait for the
    checkpointer's in-flight write, restore its newest step ``s`` (or start
    over from `make_state` without one) and resume at ``s + 1``.
    ``train_loop`` saves through ``checkpointer`` itself.  Returns
    (final_state, restarts); raises once restarts pass ``max_restarts``."""
    restarts = 0
    state = make_state()
    start = 0
    while True:
        try:
            state = train_loop(state, start)
            return state, restarts
        except NodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            checkpointer.wait()
            step = latest_step(checkpointer.dir)
            if step is None:
                state = make_state()
                start = 0
            else:
                state = checkpointer.restore(step, like=state)
                start = step + 1
            time.sleep(0)  # yield (a cluster would wait for the replacement node)
